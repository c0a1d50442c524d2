"""Device-side control flow: the port's `lax.while_loop` and `lax.cond`.

`dev_while(cond_fn, body_fn, carry, max_trips)` and
`dev_cond(pred, true_fn, false_fn, operands)` take trees of tensors
(`core/spaces.py::tmap` trees: dataclasses, tuples, lists, dicts) and run
in one of two modes, chosen by where the work goes:

- **eager** (CPU tensors, and CUDA tensors outside a graph capture, as in
  the host loop): a Python loop or branch that reads its predicate back
  once per test.  The carry is passed from trip to trip as it is, so the
  results are those of the plain Python loop, bit for bit.
- **captured** (CUDA tensors while the current stream captures a CUDA
  graph): a conditional WHILE or IF node of the graph
  (`csrc/graph_while.cu`).  The body is captured once, on a stream of its
  own per nesting depth, into the node's body graph, and runs on the
  device only while (or if) the predicate holds: nothing is masked, and no
  trip runs beyond what the eager loop runs.  The carry lives in buffers
  allocated before the node; each trip computes the new carry and writes
  it into those buffers in place (`copy_`), so every trip replays the same
  addresses.  The buffers are what `dev_while` returns.

`max_trips` bounds the trips in both modes, as an extra conjunct of the
predicate.  A captured `dev_cond` with `false_fn=None` (the identity)
writes the true branch's values into `operands` in place and returns
them; with two branches it returns new buffers that both branches write.
Either way the branches return the structure and shapes of `operands`.

A predicate with one element per LP of a batch (shape (B,), the fused
batch solve) takes `jax.vmap`'s semantics: the loop runs while any LP's
predicate holds, the body runs for all LPs, and each LP's carry takes the
body's values only where its own predicate held (`spaces.select`); an IF
body runs if any LP's predicate holds and merges the same way.  Eagerly
that is one `any()` read-back per test; captured, the same conditional
node on the `any()`, with the merge inside the body.  A predicate of one
element keeps the single-LP path, and `max_trips` counts the loop's trips
in either case.

A capture needs every allocation of its bodies in the graph's private
memory pool: `capture` routes the current thread's allocations there for
the length of a capture, and `prepare` loads the library, the condition
kernel's module and the body streams before one begins.
"""
from __future__ import annotations

import ctypes
from contextlib import contextmanager

import torch

from pips_ipmpp_tpu_torch.core.spaces import leaves, select, tmap

IF, WHILE = 0, 1
MAX_DEPTH = 8            # nested bodies one capture may open

_streams: dict = {}      # device index -> body streams, one per depth
_depth = [0]


def capturing(t) -> bool:
    """True when `t` is a CUDA tensor and the current stream captures."""
    return (isinstance(t, torch.Tensor) and t.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _first_tensor(tree):
    for x in leaves(tree):
        if isinstance(x, torch.Tensor):
            return x
    raise ValueError("the carry holds no tensor")


def dev_while(cond_fn, body_fn, carry, max_trips: int):
    """`while cond_fn(carry): carry = body_fn(carry)`, at most `max_trips`
    times.  `cond_fn` returns a bool tensor of one element, or one per LP
    of a batch (the module's docstring)."""
    if not capturing(_first_tensor(carry)):
        trips = 0
        while trips < max_trips:
            p = cond_fn(carry)
            if p.numel() == 1:
                if not bool(p):
                    break
                carry = body_fn(carry)
            else:
                if not bool(p.any()):
                    break
                carry = select(p, body_fn(carry), carry)
            trips += 1
        return carry
    buf = _own(carry)
    dev = _first_tensor(buf).device
    trips = torch.zeros((), dtype=torch.int32, device=dev)
    p = cond_fn(buf)
    if p.numel() == 1:
        with _body(_pred(p, trips, max_trips), WHILE) as finish:
            _assign(buf, body_fn(buf))
            trips.add_(1)
            finish(_pred(cond_fn(buf), trips, max_trips))
        return buf
    mask = p.to(torch.bool).clone()
    with _body(_pred(mask.any(), trips, max_trips), WHILE) as finish:
        _assign(buf, select(mask, body_fn(buf), buf))
        trips.add_(1)
        mask.copy_(cond_fn(buf))
        finish(_pred(mask.any(), trips, max_trips))
    return buf


def dev_cond(pred, true_fn, false_fn, operands: tuple):
    """`true_fn(*operands) if pred else false_fn(*operands)`; a None
    `false_fn` is the identity.  `pred` has one element, or one per LP of
    a batch (the module's docstring)."""
    batched = pred.numel() != 1
    if not capturing(pred):
        if not batched:
            if bool(pred):
                return true_fn(*operands)
            return operands if false_fn is None else false_fn(*operands)
        out = operands if false_fn is None or bool(pred.all()) \
            else false_fn(*operands)
        if bool(pred.any()):
            out = select(pred, true_fn(*operands), out)
        return out
    if batched:
        mask = pred.to(torch.bool)
        if false_fn is None:
            with _body(mask.any(), IF):
                _assign(operands, select(mask, true_fn(*operands), operands))
            return operands
        out = _own(operands, copy=False)
        with _body(mask.any(), IF):
            _assign(out, true_fn(*operands))
        with _body((~mask).any(), IF):
            _assign(out, select(mask, out, false_fn(*operands)))
        return out
    pred = pred.reshape(()).to(torch.bool)
    if false_fn is None:
        with _body(pred, IF):
            _assign(operands, true_fn(*operands))
        return operands
    out = _own(operands, copy=False)
    with _body(pred, IF):
        _assign(out, true_fn(*operands))
    with _body(pred, IF, negate=True):
        _assign(out, false_fn(*operands))
    return out


# ---- capture machinery -------------------------------------------------
def _pred(c, trips, max_trips):
    return (c.reshape(()).to(torch.bool) & (trips < max_trips)).contiguous()


def _own(tree, copy=True):
    """Fresh buffers for the tensor leaves of `tree` (copies, or
    uninitialized when `copy` is false); other leaves are kept."""
    def own(x):
        if not isinstance(x, torch.Tensor):
            return x
        return x.clone() if copy else torch.empty_like(x)
    return tmap(own, tree)


def _assign(dst_tree, src_tree):
    """Write the leaves of `src_tree` into the tensor leaves of `dst_tree`
    in place.  A source that shares memory with a destination other than
    its own is copied first, so no write clobbers a value still to be
    read.  Non-tensor leaves must agree."""
    dst = leaves(dst_tree)
    src = leaves(src_tree)
    if len(dst) != len(src):
        raise ValueError(f"branch returned {len(src)} leaves, the carry "
                         f"has {len(dst)}")
    held = {d.untyped_storage().data_ptr() for d in dst
            if isinstance(d, torch.Tensor)}
    pairs = []
    for d, s in zip(dst, src):
        if not isinstance(d, torch.Tensor):
            if isinstance(s, torch.Tensor) or s != d:
                raise ValueError(f"a non-tensor carry leaf changed: {d!r} "
                                 f"-> {s!r}")
            continue
        if s is d:
            continue
        if isinstance(s, torch.Tensor):
            if tuple(s.shape) != tuple(d.shape):
                raise ValueError(f"carry leaf of shape {tuple(d.shape)} got "
                                 f"{tuple(s.shape)}")
            if s.untyped_storage().data_ptr() in held:
                s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        if isinstance(s, torch.Tensor):
            d.copy_(s)
        else:
            d.fill_(s)


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


@contextmanager
def _body(pred, kind, negate=False):
    """Open a conditional node on the current capture and capture the
    `with` block into its body, on the body stream of this depth.  A WHILE
    body calls the yielded function with the flag of its next trip."""
    from pips_ipmpp_tpu_torch import _build

    lib = _build.load()
    depth = _depth[0]
    streams = _streams.get(_index(pred.device), [])
    if depth >= len(streams):
        raise RuntimeError(f"conditional nodes nested deeper than "
                           f"{len(streams)}: call control.prepare first")
    outer = torch.cuda.current_stream(pred.device)
    body = streams[depth]
    handle = ctypes.c_ulonglong()
    _check(lib.graph_cond_begin(outer.cuda_stream, body.cuda_stream,
                                pred.data_ptr(), int(negate), kind,
                                ctypes.byref(handle)), "graph_cond_begin")
    nxt = [None]
    _depth[0] = depth + 1
    try:
        with torch.cuda.stream(body):
            yield lambda p: nxt.__setitem__(0, p)
    except BaseException:
        # end the body's capture so the stream is usable again
        lib.graph_cond_end(body.cuda_stream, handle.value, None, IF,
                           ctypes.byref(ctypes.c_size_t()))
        raise
    finally:
        _depth[0] = depth
    if kind == WHILE and nxt[0] is None:
        raise RuntimeError("a WHILE body ended without its next flag")
    nodes = ctypes.c_size_t()
    _check(lib.graph_cond_end(body.cuda_stream, handle.value,
                              None if nxt[0] is None else nxt[0].data_ptr(),
                              kind, ctypes.byref(nodes)), "graph_cond_end")
    if nodes.value == 0:
        raise RuntimeError(f"an empty {('IF', 'WHILE')[kind]} body at depth "
                           f"{depth}: no graph takes it")


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


def prepare(device, depth: int = MAX_DEPTH):
    """Before a capture on `device`: build and load the library, load the
    condition kernel's module, and create the body streams."""
    from pips_ipmpp_tpu_torch import _build

    idx = _index(device)
    _check(_build.load().graph_cond_prepare(), "graph_cond_prepare")
    streams = _streams.setdefault(idx, [])
    while len(streams) < depth:
        streams.append(torch.cuda.Stream(idx))


@contextmanager
def capture(device):
    """Capture the block into a new CUDA graph, yielded, on a side stream
    in relaxed mode (in thread-local mode the second capture of a process
    failed on the card), with every allocation of the current thread, on any
    stream, routed into the graph's private pool: the bodies' streams are
    not the stream the graph captures on, which is all PyTorch's own
    routing takes.  The allocator keeps one routing per pool, so the block
    swaps the capture's for the thread's and, at its end, back for one
    that the capture's end removes.  Each routing begun takes a reference
    on the pool that ending it does not give back, and only the graph's
    own reference is released when the graph dies: the two this block
    adds are released after the capture, so that a dead graph's pool goes
    back to the allocator (`torch.cuda.empty_cache`) instead of staying
    reserved for the process's life."""
    idx = _index(device)
    pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="relaxed"):
        torch._C._cuda_endAllocateToPool(idx, pool)
        torch._C._cuda_beginAllocateCurrentThreadToPool(idx, pool)
        try:
            yield graph
        finally:
            torch._C._cuda_endAllocateToPool(idx, pool)
            torch._C._cuda_beginAllocateCurrentStreamToPool(idx, pool)
    for _ in range(2):
        torch._C._cuda_releasePool(idx, pool)
