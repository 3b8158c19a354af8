from encbench.reference.av1.decoder.decode import decode_packet

__all__ = ["decode_packet"]
