from encbench.reference.av1.context.cdf import CDFContext, CDFContextLog
from encbench.reference.av1.context.block import BlockContext, FrameBlocks
from encbench.reference.av1.context.writer import ContextWriter

__all__ = [
    "BlockContext",
    "CDFContext",
    "CDFContextLog",
    "ContextWriter",
    "FrameBlocks",
]
