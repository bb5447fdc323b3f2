"""The device an entry point runs on: the card unless the caller asks for
the CPU, and no quiet fallback when there is no card.

:func:`trace_for_card` is the one other route: inside it the kernel
wrappers take fake tensors (``torch._subclasses.fake_tensor``) of any
device down the route an H100 would take, to the dispatcher ops whose
fakes give the kernels' outputs, and count the kernel calls.  The dry run
(``launch/dryrun.py``) enters it; nothing else does.
"""
from __future__ import annotations

import collections
import contextlib

import torch

#: the kernel-call counters of the active :func:`trace_for_card` contexts
#: (a module global, not thread-local: autograd's backward may run on
#: another thread)
_CARD_TRACES: list[collections.Counter] = []


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; for CUDA, raise without a card and turn TF32
    off (the f32 policy must mean f32 on the card too)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu "
                               "to run the plain PyTorch versions")
        # f32 matmuls and convolutions in full f32, not TF32 (three decimal
        # digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


@contextlib.contextmanager
def trace_for_card():
    """Inside: every kernel wrapper takes its H100 route on fake tensors of
    any device (the routes' own checks kept, the dispatcher op's fake
    standing in for the launch) and raises on a tensor that is not fake.
    Yields a ``Counter`` of the kernel calls traced, by the launch
    counter's name (``build.Kernel.entry``: ``flash_fwd_sm90``,
    ``flash_decode_bias``, ...), the twin of the kernels' ``launches``."""
    calls: collections.Counter = collections.Counter()
    _CARD_TRACES.append(calls)
    try:
        yield calls
    finally:
        _CARD_TRACES.remove(calls)


def card_trace_active() -> bool:
    return bool(_CARD_TRACES)


def _check_fake(tensors) -> None:
    from torch._subclasses.fake_tensor import is_fake
    for t in tensors:
        if not is_fake(t):
            raise RuntimeError(
                f"trace_for_card: a real {t.device.type} tensor of shape "
                f"{tuple(t.shape)} reached a kernel wrapper; the card trace "
                f"takes fake tensors only")


def on_card(*tensors) -> bool:
    """Do the kernels take these tensors?  A CUDA first tensor does; inside
    :func:`trace_for_card` fake tensors of any device do, and a real one
    raises.  Otherwise the wrapper runs its plain version."""
    if _CARD_TRACES:
        _check_fake(tensors)
        return True
    return tensors[0].is_cuda


def on_one_card(*tensors) -> bool:
    """All of ``tensors`` on the first one's CUDA device (inside
    :func:`trace_for_card`: all fake, on one device)."""
    if _CARD_TRACES:
        _check_fake(tensors)
    elif not tensors[0].is_cuda:
        return False
    return all(t.device == tensors[0].device for t in tensors)


def misaligned(t: torch.Tensor, to: int = 16) -> bool:
    """Is ``t``'s first element off a ``to``-byte boundary?  A fake tensor
    has no address: the card's allocator aligns every block, so it is
    taken as aligned."""
    if _CARD_TRACES:
        return False
    return t.data_ptr() % to != 0


def count_card_call(kernel) -> None:
    """Count one traced call of ``kernel`` (a ``build.Kernel``) in every
    active :func:`trace_for_card`."""
    for calls in _CARD_TRACES:
        calls[kernel.entry] += 1
