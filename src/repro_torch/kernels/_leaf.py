"""The seam through which the graph tracer sees a kernel wrapper as one
node.

:func:`graph_leaf` wraps a kernel wrapper (``apr_matmul``, ``apr_conv2d``,
``flash_decode_paged``, MobileNet's ``depthwise``).  Outside a trace the call goes straight
through.  While :mod:`repro_torch.graph.trace` traces a function it sets
:data:`tracer`, and a call records one node of the graph instead of
running: the graph then holds the kernel's entry point, never the
operations of its plain version, and the executor replays the node by
calling the same wrapper on the real tensors.  The tracer is the calling
thread's (as PyTorch's dispatch modes are): a trace in one thread leaves
another thread's kernel calls running.
"""
from __future__ import annotations

import functools
import threading

_state = threading.local()


def active_tracer():
    """The graph tracer tracing in this thread, else None."""
    return getattr(_state, "tracer", None)


def set_tracer(tracer) -> None:
    """Make ``tracer`` (or None) this thread's active graph tracer."""
    _state.tracer = tracer


def graph_leaf(fn):
    """Make ``fn`` one node of a traced graph (see the module docstring).
    The returned function is the one callers hold, so attributes set on it
    after the definition (the launch counters) live on it."""
    @functools.wraps(fn)
    def leaf(*args, **kwargs):
        tracer = active_tracer()
        if tracer is not None:
            return tracer.leaf(leaf, args, kwargs)
        return fn(*args, **kwargs)
    return leaf
