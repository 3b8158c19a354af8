"""A recorder of the operations a CUDA graph capture cannot hold, for the
port's tests of its replayed programs (``rav1e_tpu_torch/device/
graphs.py``): on the CPU, code that runs inside a capture on a card must
make none of them."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class HostReads(TorchDispatchMode):
    """Records the operations a CUDA graph capture cannot hold: a read of a
    device value on the host, a tensor made from host data, an index by a
    boolean mask (its size is read on the host)."""

    NAMES = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh",
             "aten.masked_select", "aten.repeat_interleave.Tensor")

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.NAMES):
            self.found.append(name)
        elif name.startswith(("aten.index.", "aten.index_put")) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ()) or ()):
            self.found.append(name + " (boolean mask)")
        return func(*args, **(kwargs or {}))
