from rav1e_tpu_torch.context.cdf import CDFContext, CDFContextLog
from rav1e_tpu_torch.context.block import BlockContext, FrameBlocks
from rav1e_tpu_torch.context.writer import ContextWriter

__all__ = [
    "BlockContext",
    "CDFContext",
    "CDFContextLog",
    "ContextWriter",
    "FrameBlocks",
]
