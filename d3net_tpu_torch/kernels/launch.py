"""The one launch path of the port's ctypes kernels.

Every C entry point in ``csrc/`` takes PyTorch's current stream as its
last argument, launches on it and returns ``cudaGetLastError()``.
``launch`` is the host path between a wrapper's checks and that call, kept
to what a launch needs:

- the C function is bound once, with its ``argtypes``, by the kernel
  module's ``load_library``;
- the device is switched only when the tensors' device is not the current
  one (a ``torch.cuda.device`` block costs a few µs per call);
- the current stream is read as a raw pointer, without building a
  ``torch.cuda.Stream`` object per call;
- any non-zero return raises.

It caches no outputs, keeps no CUDA graph, and the wrappers keep every
dtype, device, contiguity and shape check.
"""

from __future__ import annotations

import torch

# Two private helpers of torch 2.11's CUDA builds, the ones
# ``torch.cuda.current_device()`` and PyTorch's Inductor call:
# ``_cuda_getDevice()`` gives the current device index and
# ``_cuda_getCurrentRawStream(index)`` that device's current stream as an
# int. A build without them takes the public calls, which give the same.
_current_device = getattr(torch._C, "_cuda_getDevice",
                          torch.cuda.current_device)
current_stream = getattr(
    torch._C, "_cuda_getCurrentRawStream",
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def launch(name: str, fn, index: int, *args) -> None:
    """``fn(*args, stream)`` on the current stream of CUDA device ``index``
    (a CUDA tensor's ``get_device()``); raises RuntimeError naming ``name``
    if the C side returns a CUDA error."""
    if _current_device() == index:
        err = fn(*args, current_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, current_stream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
