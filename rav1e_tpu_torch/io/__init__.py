from rav1e_tpu_torch.io.ivf import IvfWriter, read_ivf
from rav1e_tpu_torch.io.y4m import Y4MReader, Y4MWriter

__all__ = ["IvfWriter", "Y4MReader", "Y4MWriter", "read_ivf"]
