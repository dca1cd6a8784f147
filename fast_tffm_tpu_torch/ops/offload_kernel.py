"""The offload row kernels' wrappers (``csrc/offload_rows.cu``): the
gather of a batch's rows out of the host-resident table and the
sparse-Adagrad write-back into it, for ``lookup = host`` (lookup.py).

In the JAX package these are XLA's host-memory-space gather and scatter
in ``fast_tffm_tpu/lookup.py:_fused_step_fn``; no Pallas kernel stands
behind them, and no PyTorch op can index host memory from the card.

- ``offload_gather(table, uniq_ids) -> rows [U, D]`` on ``uniq_ids``'s
  device.
- ``offload_adagrad(table, acc, uniq_ids, rows, grad, lr)``: ``a = acc +
  g²``, ``rows − lr·g·rsqrt(a)``, both written back to ``table`` and
  ``acc`` at ``uniq_ids``; ``rows`` are the rows the step gathered.

``table`` and ``acc`` are ``[R, D]`` float32 CPU tensors. Ids, rows and
gradients on the card: the state must be page-locked
(``register_host``), and the kernel launches on the current stream,
reading and writing that host memory directly; a failed build, launch
or lookup of the state's device address raises, and nothing falls back.
On the CPU: the plain versions, index ops on CPU tensors.

``register_host(t, device)`` page-locks a CPU tensor's memory in place
(``cudaHostRegister``, mapped for the card) and unregisters it when the
tensor object is collected (or at ``unregister_host``), never after its
memory is freed: the memory lives at least as long as the tensor object.

``gather_launches`` and ``adagrad_launches`` count kernel launches
(never plain-version calls).
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import Dict, Tuple

import torch

from fast_tffm_tpu_torch.ops import build

gather_launches = 0
adagrad_launches = 0
_count_lock = threading.Lock()
_registered: Dict[int, weakref.finalize] = {}  # host address -> finalizer
_reg_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return build.load_offload_rows()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: {_library().offload_error_string(rc).decode()}")


def _unregister(ptr: int) -> None:
    with _reg_lock:
        _registered.pop(ptr, None)
    _raise_on(_library().offload_host_unregister(ptr),
              "cudaHostUnregister of offload state")


def register_host(t: torch.Tensor, device: torch.device) -> None:
    """Page-lock the memory of CPU tensor ``t`` in place and map it for
    the card (no copy: the bytes stay where they are). Unregistered when
    ``t`` is collected, or by ``unregister_host(t)``."""
    _check_state("register_host", t)
    ptr = t.data_ptr()
    with _reg_lock:
        if ptr in _registered:
            raise ValueError("register_host: this memory is already "
                             "registered")
    _raise_on(_library().offload_host_register(
        ptr, t.numel() * t.element_size(), torch.device(device).index or 0),
        f"cudaHostRegister of {t.numel() * 4} bytes of offload state")
    fin = weakref.finalize(t, _unregister, ptr)
    # At exit the process's pages go with it; the runtime may be gone.
    fin.atexit = False
    with _reg_lock:
        _registered[ptr] = fin


def unregister_host(t: torch.Tensor) -> None:
    """Undo ``register_host(t)`` now (a no-op for memory it did not
    register)."""
    with _reg_lock:
        fin = _registered.get(t.data_ptr())
    if fin is not None:
        fin()


def registered_bytes() -> int:
    """Bytes this process holds page-locked through ``register_host``."""
    with _reg_lock:
        fins = list(_registered.values())
    total = 0
    for fin in fins:
        got = fin.peek()
        if got is not None:
            t = got[0]
            total += t.numel() * t.element_size()
    return total


def is_page_locked(t: torch.Tensor) -> bool:
    """Whether CPU tensor ``t``'s data is page-locked and mapped for the
    card (``register_host``, or torch's pinned allocator)."""
    out = ctypes.c_void_p()
    return _library().offload_device_pointer(t.data_ptr(),
                                              ctypes.byref(out)) == 0


def _device_address(t: torch.Tensor) -> int:
    """The card's address of page-locked CPU tensor ``t``'s data."""
    out = ctypes.c_void_p()
    rc = _library().offload_device_pointer(t.data_ptr(), ctypes.byref(out))
    if rc != 0:
        raise ValueError(
            "offload state is not in page-locked host memory "
            "(ops/offload_kernel.register_host): "
            f"{_library().offload_error_string(rc).decode()}")
    return int(out.value)


def _check_state(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu" or t.dtype != torch.float32 or \
            t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} takes a contiguous float32 [R, D] CPU "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU (the plain version runs);
    True when all lie on one CUDA device; raises otherwise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name} needs its ids, rows and gradients on one "
                         "device, got "
                         + ", ".join(str(t.device) for t in tensors))
    return True


def _check_batch(uniq_ids: torch.Tensor, D: int, *blocks: torch.Tensor
                 ) -> None:
    if uniq_ids.dtype != torch.int32 or uniq_ids.dim() != 1 or \
            not uniq_ids.is_contiguous():
        raise ValueError(f"uniq_ids must be a contiguous int32 [U], got "
                         f"{uniq_ids.dtype} {tuple(uniq_ids.shape)}")
    for b in blocks:
        if b.dtype != torch.float32 or \
                tuple(b.shape) != (uniq_ids.shape[0], D) or \
                not b.is_contiguous():
            raise ValueError(
                f"rows and gradients must be contiguous float32 "
                f"[{uniq_ids.shape[0]}, {D}], got {b.dtype} "
                f"{tuple(b.shape)}")


# -- the plain versions ----------------------------------------------------

def offload_gather_plain(table: torch.Tensor,
                         uniq_ids: torch.Tensor) -> torch.Tensor:
    """``table[uniq_ids]``: index ops on CPU tensors."""
    return table.index_select(0, uniq_ids.long())


def adagrad_rows(acc_rows: torch.Tensor, rows: torch.Tensor,
                 grad: torch.Tensor, lr: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(new_acc, new_rows)``: ``acc + g²`` and ``rows − (lr·g)·rsqrt(
    new_acc)``, in the kernel's order of operations, on any device."""
    new_acc = acc_rows + torch.square(grad)
    return new_acc, rows - (lr * grad) * torch.rsqrt(new_acc)


def offload_adagrad_plain(table: torch.Tensor, acc: torch.Tensor,
                          uniq_ids: torch.Tensor, rows: torch.Tensor,
                          grad: torch.Tensor, lr: float) -> None:
    """The write-back with index ops on CPU tensors. Duplicate ids (the
    pad slots) carry zero gradient and store equal values."""
    ids = uniq_ids.long()
    new_acc, new_rows = adagrad_rows(acc.index_select(0, ids), rows, grad,
                                     lr)
    acc.index_copy_(0, ids, new_acc)
    table.index_copy_(0, ids, new_rows)


# -- the wrappers ----------------------------------------------------------

def offload_gather(table: torch.Tensor,
                   uniq_ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[uniq_ids]`` ``[U, D]`` on ``uniq_ids``'s device: the
    kernel for ids on the card (``table`` page-locked), the plain version
    for ids on the CPU."""
    _check_state("offload_gather", table)
    R, D = table.shape
    _check_batch(uniq_ids, D)
    if not _on_card("offload_gather", uniq_ids):
        return offload_gather_plain(table, uniq_ids)
    U = uniq_ids.shape[0]
    out = torch.empty((U, D), dtype=torch.float32, device=uniq_ids.device)
    if U == 0:
        return out
    dev = uniq_ids.device.index
    lib = _library()
    rc = lib.offload_gather(
        _device_address(table), uniq_ids.data_ptr(), out.data_ptr(), R, D,
        U, dev, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"offload_gather kernel launch failed (U={U}, "
                           f"D={D}): {lib.offload_error_string(rc).decode()}")
    global gather_launches
    with _count_lock:
        gather_launches += 1
    return out


def offload_adagrad(table: torch.Tensor, acc: torch.Tensor,
                    uniq_ids: torch.Tensor, rows: torch.Tensor,
                    grad: torch.Tensor, lr: float) -> None:
    """Sparse Adagrad of rows ``uniq_ids``, written into ``table`` and
    ``acc`` in place: the kernel for ids, rows and gradient on the card
    (the state page-locked), the plain version for CPU tensors."""
    _check_state("offload_adagrad", table)
    _check_state("offload_adagrad", acc)
    if tuple(acc.shape) != tuple(table.shape):
        raise ValueError(f"acc {tuple(acc.shape)} and table "
                         f"{tuple(table.shape)} differ in shape")
    R, D = table.shape
    _check_batch(uniq_ids, D, rows, grad)
    if not _on_card("offload_adagrad", uniq_ids, rows, grad):
        offload_adagrad_plain(table, acc, uniq_ids, rows, grad, lr)
        return
    U = uniq_ids.shape[0]
    if U == 0:
        return
    dev = uniq_ids.device.index
    lib = _library()
    rc = lib.offload_adagrad(
        _device_address(table), _device_address(acc), uniq_ids.data_ptr(),
        rows.data_ptr(), grad.data_ptr(), float(lr), R, D, U, dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"offload_adagrad kernel launch failed (U={U}, "
                           f"D={D}): {lib.offload_error_string(rc).decode()}")
    global adagrad_launches
    with _count_lock:
        adagrad_launches += 1
