"""Host -> device copies of numpy batches through a ring of page-locked
staging buffers.

A copy from pageable memory makes the host wait for it, and the copy
waits for the work queued before it on the stream: the host cannot load
the next batch while the card runs the current one.  A copy from
page-locked memory with ``non_blocking=True`` returns at once.  The
price is that the staging buffer is still being read after the call
returns, so a slot is refilled only after the copy that last read it has
completed: each slot records an event after its copy, and the next
:meth:`PinnedRing.put` into that slot waits on it before ``np.copyto``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


class _Slot:
    def __init__(self, host: torch.Tensor):
        self.host = host
        self.array = host.numpy()
        self.done = None  # the event recorded after the copy that read ``host``


class PinnedRing:
    """``put(arr)`` -> ``arr`` as a tensor on ``device``.  On a CUDA device
    each call takes the next of ``slots`` page-locked buffers (allocated at
    first use, again when the array's shape or dtype changes), waits for the
    copy that last read it, fills it and starts an asynchronous copy on the
    current stream.  With ``slots`` at least the number of arrays in flight
    (a batch's arrays times the batches queued ahead), the wait returns at
    once in steady state.  On the CPU, ``put`` wraps the array, with no
    copy."""

    def __init__(self, device: Union[str, torch.device], slots: int = 2):
        if slots < 1:
            raise ValueError(f"a ring needs at least one slot, got {slots}")
        self.device = torch.device(device)
        self._slots = [None] * slots
        self._next = 0

    @property
    def staged(self) -> bool:
        """Whether ``put`` copies through the staging buffers."""
        return self.device.type == "cuda"

    def put(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if not self.staged:
            return torch.from_numpy(arr).to(self.device)
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None and slot.done is not None:
            slot.done.synchronize()
        if slot is None or slot.array.shape != arr.shape or slot.array.dtype != arr.dtype:
            slot = self._slots[i] = _Slot(self._alloc(arr))
        np.copyto(slot.array, arr)
        out, slot.done = self._copy(slot.host)
        return out

    def _alloc(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).pin_memory()

    def _copy(self, host: torch.Tensor):
        """Start the copy of ``host`` to the device: (the device tensor, an
        event that completes with the copy)."""
        out = host.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return out, done
