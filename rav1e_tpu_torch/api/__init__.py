from rav1e_tpu_torch.api.context import Context

__all__ = ["Context"]
