"""The host-read audit of a step that a CUDA graph records: a dispatch
mode that raises on each op a capture refuses.  Imported by the train
step's graph tests and by the ranks of the mesh graph tests
(``tests/_mesh_graph_ranks.py``), so it imports neither JAX nor the JAX
package."""
import inspect

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
# Ops whose result the host must read, or whose output shape the data sets:
# a capture refuses both.  lift_fresh is a tensor made from host data
# (torch.tensor, torch.as_tensor of a Python number), on the card a
# synchronous host-to-device copy.
HOST_READS = {aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten._unique2,
              aten.unique_dim, aten.unique_consecutive, aten.repeat_interleave, aten.bincount,
              aten.equal, aten.is_nonzero, aten.lift_fresh}
# Plain versions that read the host where their CUDA route does not: none
# on the train path (every family's step runs clean), so the set is empty.
EXEMPT: set = set()
# On the decode path: flash_decode's plain version sizes its tile loop on
# the host (``int(needed_tiles(...).max())``); its kernel reads no host.
DECODE_EXEMPT = {"flash_decode_plain"}


class HostReadAudit(TorchDispatchMode):
    """Raise on every op of ``HOST_READS``, and on an index by a boolean
    mask (a hidden ``nonzero``), unless a frame of the Python stack is a
    function named in ``exempt`` (``EXEMPT`` by default)."""

    def __init__(self, exempt=None) -> None:
        super().__init__()
        self.exempt = EXEMPT if exempt is None else set(exempt)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        bad = func.overloadpacket in HOST_READS or (
            func.overloadpacket in (aten.index, aten.index_put, aten.index_put_) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple))
                          else ())))
        if bad:
            stack = inspect.stack()
            if not any(f.function in self.exempt for f in stack):
                where = next((f"{f.filename.split('src/')[-1]}:{f.lineno} ({f.function})"
                              for f in stack if "repro_torch" in f.filename), "?")
                raise AssertionError(f"{func} reads the host inside the train step, at {where}")
        return func(*args, **kwargs)
