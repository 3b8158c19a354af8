from rav1e_tpu_torch.decoder.decode import decode_packet

__all__ = ["decode_packet"]
