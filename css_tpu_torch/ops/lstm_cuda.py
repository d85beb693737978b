"""K2: the fused LSTM recurrence — the CUDA kernel ``csrc/lstm.cu`` and its
plain version.

Replaces the TPU kernel ``css_tpu/ops/lstm_pallas.py:lstm_fused`` (body
``_lstm_kernel``): the whole time loop of one LSTM direction over
precomputed input projections xw (B, T, 4h) and the recurrent weights
W_hh (h, 4h), gate order i, f, g, o, ``reverse`` running time backward.
The function ported is the TPU kernel's, which is what the BLSTM's eval
path ran on the TPU: gates and the cell state c in float32, h rounded to
the input dtype every step, the output in the input dtype; bf16 products
summed in float32, float32 products to ~21 of float32's 24 bits (3xTF32
on the tensor cores, never an operand rounded to TF32 alone). (The JAX
package's
``lstm_scan`` in bf16, its CPU path, keeps c in bf16 instead.) On the
main path it runs every (layer, direction) of the BLSTM
(``models/blstm.py``): 6 launches per separator batch at full width.

What bounds the function on the H100: operations — at the main shape
(32, 150, 512) float32, the recurrent products are 10.07 GFLOP, 0.061 ms
at 3xTF32's 165 TFLOP/s (a third of the 495 TFLOP/s TF32 peak; 0.150 ms
at the 67 TFLOP/s FP32 peak of the CUDA cores), against 53 MB of bytes
(0.016 ms); the 149 dependent steps add a latency floor that the bound
does not count. The kernel is persistent: one launch of thread-block
clusters runs all T steps, each block keeps its slice of W_hh in shared
memory and its cells' c in registers, each cluster reads h_{t-1} from L2
once and multicasts it to its blocks, the product runs on the tensor
cores (mma.sync), and an arrival counter is the grid barrier between
steps; see the source.

The launch geometry is fixed for the H100: at most MAX_BLOCKS blocks in
clusters of 8, one block per SM (5 units a block at hidden 512, 9 at
1024). Every call of ``lstm_fused(xw, w_hh, hidden)`` goes through the
registered operator ``css_tpu_torch::lstm_fused`` (``lstm_op``), so
``torch.export`` keeps K2 as one node and an exported BLSTM launches it
when served (``cli/export.py``); only the measurement route ``phases=``
launches directly. On CPU tensors the op runs the plain version. On CUDA
tensors it launches the kernel, or raises, except on one route, decided
from the hidden size and dtype alone before any launch and counted in
``lstm_fused.plain_routes``: **a hidden size whose W_hh slice does not
fit in a block's shared memory** (``lstm_plan`` returns None: from 1193
units in float32 and 1441 in bf16) runs the plain version on the card,
as the reference runs shapes its kernel does not tile on XLA.
A card that cannot hold all of a plan's clusters at once raises a
ValueError that names the shape (the kernel's barrier would wait for a
cluster that never starts). A batch above ``MAX_BATCH`` rows is split
across launches (batch entries are independent, so this is exact).
``lstm_fused.launches`` counts kernel launches, and the op's CUDA kernel
counts them, so a served artifact's launches count as the live model's.

Streaming (hop-granular, a causal LSTM over chunks of a few frames) hands
the recurrence a carried state: ``state=(h0, c0)``, h0 (B, h) in xw's
dtype and c0 (B, h) float32, and ``return_state=True`` returns the final
(h, c), c in float32. The kernel reads h0 where its step 0 reads h_{t-1}
and starts its c registers at c0, so launches chained over chunks equal
one launch over the whole sequence. A reverse scan has no causal carry to
chain: ``reverse`` with a state raises. (The JAX package runs the carried
recurrence as a scan outside its Pallas kernel, with c in the compute
dtype; in float32 the two are the same function.)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from css_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)
SHAPE_REFUSED = -1  # css_lstm's return for a plan the kernel does not take
NOT_RESIDENT = -2  # css_lstm's return when the clusters cannot all run

# the kernel's fixed geometry (csrc/lstm.cu)
WARPS = 8  # warps per block (256 threads), each a share of the k steps
MAX_BATCH = 32  # rows per launch: two 16-row mma tiles
MAX_COLS = 48  # gate columns per block (12 units): six 8-column tiles
CLUSTER = 8  # blocks per cluster
# 15 clusters of 8 at one block per SM: what cudaOccupancyMaxActiveClusters
# reports on the H100 SXM (a cluster lies within one GPC, so some of the
# 132 SMs stay out); the kernel's host code checks it before a launch
MAX_BLOCKS = 120
# shared memory a block can opt into on the H100 and H200 (227 KB)
SMEM_OPTIN = 232448


class LstmPlan(NamedTuple):
    """One launch's layout: ``units`` hidden units per block over
    ``blocks`` blocks (a whole number of clusters); W_hh's slice in rows of
    ``wstride`` columns (8 or 24 mod 32 words: conflict-free mma fragment
    reads); h padded to ``hpad`` (a whole mma k step) and staged
    in chunks of ``chunk`` columns into shared-memory rows ``hstride``
    elements apart (16 mod 128 bytes: conflict-free); ``smem`` bytes of
    shared memory for MAX_BATCH rows."""
    units: int
    blocks: int
    hpad: int
    wstride: int
    chunk: int
    hstride: int
    smem: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def lstm_plan(hidden: int, elem: int) -> Optional[LstmPlan]:
    """The kernel's layout for ``hidden`` units (``elem`` bytes a value: 4
    float32, 2 bf16) over at most MAX_BLOCKS blocks in clusters of
    CLUSTER, or None when a block's W_hh slice does not fit (more than
    MAX_COLS gate columns, or no room left beside it in SMEM_OPTIN bytes
    for the partial products and a 128-byte chunk of h): the plain route.
    A batch above MAX_BATCH is split across launches by the wrapper."""
    units = -(-hidden // MAX_BLOCKS)
    blocks = _round_up(-(-hidden // units), CLUSTER)
    npad = _round_up(4 * units, 8)
    if npad > MAX_COLS:
        return None
    wstride = npad if npad % 32 in (8, 24) else npad + 8
    hpad = _round_up(hidden, 32 // elem)  # an mma k step: 8 or 16
    per_row = 128 // elem  # elements of 128 bytes
    pad = 16 // elem  # the 16 bytes that put rows in distinct banks
    room = SMEM_OPTIN - hpad * wstride * elem - 16
    part = WARPS * MAX_BATCH * npad * 4
    cap = (room // (MAX_BATCH * elem) - pad) // per_row * per_row
    if room < part or cap < per_row:
        return None
    chunk = min(cap, hpad)
    hstride = _round_up(chunk, per_row) + pad
    smem = (hpad * wstride * elem + 16
            + max(MAX_BATCH * hstride * elem, part))
    return LstmPlan(units, blocks, hpad, wstride, chunk, hstride, smem)


def _zero_state(xw: torch.Tensor, hidden: int):
    """The zero (h in xw's dtype, c float32) of a sequence's start."""
    b = xw.shape[0]
    return (xw.new_zeros((b, hidden)),
            torch.zeros((b, hidden), dtype=torch.float32, device=xw.device))


def _initial_state(xw: torch.Tensor, hidden: int, reverse: bool, state,
                   return_state: bool):
    """``state`` as (h0 in xw's dtype, c0 float32), contiguous on xw's
    device, or None without one; raises for a reverse scan with a carry."""
    if reverse and (state is not None or return_state):
        raise ValueError("lstm: a reverse scan has no causal carry to chain "
                         "(state and return_state are forward only)")
    if state is None:
        return None
    b = xw.shape[0]
    h0, c0 = state
    if tuple(h0.shape) != (b, hidden) or tuple(c0.shape) != (b, hidden):
        raise ValueError(f"lstm state: h0 and c0 are (B, h) = {(b, hidden)},"
                         f" got {tuple(h0.shape)} and {tuple(c0.shape)}")
    return (h0.to(device=xw.device, dtype=xw.dtype).contiguous(),
            c0.to(device=xw.device, dtype=torch.float32).contiguous())


def _scan(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int, reverse: bool,
          state) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain loop from ``state`` (as ``_initial_state`` gives it, or
    None for zeros) -> (hs, the last step's h, its c float32)."""
    b, t, _ = xw.shape
    w = w_hh.float()
    h, c = state or _zero_state(xw, hidden)
    out = torch.empty((b, t, hidden), dtype=xw.dtype, device=xw.device)
    for s in range(t):
        ti = t - 1 - s if reverse else s
        gates = xw[:, ti].float() + h.float() @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(xw.dtype)
        out[:, ti] = h
    return out, h, c


def lstm_plain(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int,
               reverse: bool = False, state=None, return_state: bool = False):
    """The plain PyTorch version: a loop over time with the TPU kernel's
    numerics. xw (B, T, 4h), w_hh (h, 4h) -> hs (B, T, h) in xw's dtype;
    with ``return_state`` also the final (h, c float32). ``state`` is the
    initial (h0, c0), zeros without it."""
    out, h, c = _scan(xw, w_hh, hidden, reverse, _initial_state(
        xw, hidden, reverse, state, return_state))
    return (out, (h, c)) if return_state else out


def _check(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> None:
    if xw.dtype not in DTYPES or w_hh.dtype != xw.dtype:
        raise TypeError(f"lstm kernel takes float32 or bfloat16 operands of "
                        f"one dtype, got {xw.dtype} and {w_hh.dtype}")
    if (hidden <= 0 or xw.ndim != 3 or xw.shape[2] != 4 * hidden
            or tuple(w_hh.shape) != (hidden, 4 * hidden)):
        raise ValueError(f"lstm kernel takes xw (B, T, 4h) and w_hh (h, 4h) "
                         f"with h = {hidden}, got {tuple(xw.shape)} and "
                         f"{tuple(w_hh.shape)}")
    if not (xw.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("lstm kernel needs contiguous xw and w_hh")
    if w_hh.device != xw.device:
        raise ValueError(f"lstm kernel: xw on {xw.device}, w_hh on "
                         f"{w_hh.device}")


def _launch(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int,
            reverse: bool, state, phases: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors -> (hs, h_T, c_T float32), each a tensor of its
    own; ``state`` as ``_initial_state`` gives it. Counts every launch,
    and the plain route, in ``lstm_fused``'s counters."""
    _check(xw, w_hh, hidden)
    b, t, _ = xw.shape
    carried = state is not None
    plan = lstm_plan(hidden, xw.element_size())
    if plan is None:
        _COUNTS.plain_routes += 1
        out, h, c = _scan(xw, w_hh, hidden, reverse, state)
        return out, h.clone(), c.clone()
    out = torch.empty((b, t, hidden), dtype=xw.dtype, device=xw.device)
    if b == 0 or t == 0:
        h, c = state or _zero_state(xw, hidden)
        return out, h.clone(), c.clone()
    h0, c0 = state if carried else (None, None)
    c_out = torch.empty((b, hidden), dtype=torch.float32, device=xw.device)
    parts = _build.split_rows(b, MAX_BATCH)
    if phases is not None and (len(parts) != 1 or phases.dtype != torch.int64
                               or phases.shape != (plan.blocks, 4)
                               or carried):
        raise ValueError(f"lstm phases: one launch without a state and an "
                         f"int64 ({plan.blocks}, 4) buffer")
    slots = torch.zeros((2, MAX_BATCH, plan.hpad), dtype=xw.dtype,
                        device=xw.device)
    counters = torch.zeros(len(parts), dtype=torch.int32, device=xw.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    for i, (lo, hi) in enumerate(parts):
        if carried:
            # h0's rows where step 0 reads h_{t-1}: slot 1 of a launch of
            # hi - lo rows, (hi - lo, hpad) at offset (hi - lo) * hpad; the
            # padding columns stay zero (the kernel writes units < hidden)
            n = hi - lo
            slots.view(-1)[n * plan.hpad: 2 * n * plan.hpad].view(
                n, plan.hpad)[:, :hidden].copy_(h0[lo:hi])
        err = lib.css_lstm(
            xw[lo].data_ptr(), w_hh.data_ptr(), out[lo].data_ptr(),
            slots.data_ptr(), counters[i].data_ptr(),
            None if phases is None else phases.data_ptr(),
            c0[lo].data_ptr() if carried else None, c_out[lo].data_ptr(),
            int(carried), hi - lo, t, hidden, plan.hpad, plan.units,
            plan.wstride, plan.chunk, plan.hstride, plan.blocks, int(reverse),
            int(xw.dtype == torch.bfloat16), xw.device.index or 0, stream)
        if err == SHAPE_REFUSED:
            raise ValueError(f"lstm kernel: xw {tuple(xw.shape)} (batch "
                             f"{hi - lo} a launch), hidden {hidden} "
                             f"({xw.dtype}): the plan {plan} does not fit "
                             f"this card")
        if err == NOT_RESIDENT:
            raise ValueError(f"lstm kernel: xw {tuple(xw.shape)} (batch "
                             f"{hi - lo} a launch), hidden {hidden} "
                             f"({xw.dtype}): {plan.blocks} blocks in clusters "
                             f"of {CLUSTER} cannot all be resident at once "
                             f"on this card")
        _build.check(err, "lstm_fused")
        _COUNTS.launches += 1
    return out, out[:, 0 if reverse else -1].clone(), c_out


# K2 as a registered operator, so that torch.export keeps it as one node of
# the graph (an exported BLSTM serves with its kernel): the CPU kernel is
# the plain loop, the CUDA kernel the launch above, the fake kernel gives
# the shapes for tracing. No autograd formula: training runs
# models.blstm.lstm_scan(differentiable=True), a loop autograd records.
@torch.library.custom_op("css_tpu_torch::lstm_fused", mutates_args=(),
                         device_types="cpu")
def lstm_op(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int,
            reverse: bool, h0: Optional[torch.Tensor] = None,
            c0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xw (B, T, 4h), w_hh (h, 4h), the initial (h0, c0) or None ->
    (hs (B, T, h) in xw's dtype, the last step's h (B, h), its c (B, h)
    float32)."""
    state = _initial_state(xw, hidden, reverse, _pair(h0, c0), False)
    out, h, c = _scan(xw, w_hh, hidden, reverse, state)
    return out, h.clone(), c.clone()


@lstm_op.register_kernel("cuda")
def _lstm_op_cuda(xw, w_hh, hidden, reverse, h0=None, c0=None):
    return _launch(xw, w_hh, hidden, reverse,
                   _initial_state(xw, hidden, reverse, _pair(h0, c0), False))


@lstm_op.register_fake
def _lstm_op_fake(xw, w_hh, hidden, reverse, h0=None, c0=None):
    b, t, _ = xw.shape
    return (xw.new_empty((b, t, hidden)), xw.new_empty((b, hidden)),
            xw.new_empty((b, hidden), dtype=torch.float32))


def _pair(h0, c0):
    if (h0 is None) != (c0 is None):
        raise ValueError("lstm state: h0 and c0 come together")
    return None if h0 is None else (h0, c0)


def lstm_fused(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int,
               reverse: bool = False, state=None, return_state: bool = False,
               phases: Optional[torch.Tensor] = None):
    """xw (B, T, 4h) input projections plus biases, w_hh (h, 4h) ->
    hs (B, T, h) in xw's dtype (float32 or bfloat16); with
    ``return_state`` the pair (hs, (h_T, c_T float32)). ``state`` is the
    initial (h0, c0) of a stream's chunk (forward only), zeros without it.
    Every call goes through the registered op ``lstm_op``: K2 on CUDA
    tensors, the plain loop on CPU tensors.

    ``phases``, for measurement only: a CUDA int64 tensor (blocks, 4) that
    the kernel fills with each block's clock64() cycles of barrier wait,
    staging, product, and the rest (partial sums, gates, stores, arrival)
    over steps 1..T-1 (one launch, no state). This route launches K2
    directly, outside the op."""
    if reverse and (state is not None or return_state):
        raise ValueError("lstm: a reverse scan has no causal carry to chain "
                         "(state and return_state are forward only)")
    if xw.device.type != "cpu":
        # the kernel's operand checks, before the op looks for a kernel
        _check(xw, w_hh, hidden)
        if xw.device.type != "cuda":
            raise ValueError(f"lstm_fused: unsupported device {xw.device}")
    if phases is not None:
        if xw.device.type != "cuda":
            raise ValueError("lstm phases: the kernel's record needs CUDA "
                             "tensors")
        return _launch(xw, w_hh, hidden, reverse, None, phases)[0]
    h0, c0 = state if state is not None else (None, None)
    out, h_t, c_t = lstm_op(xw, w_hh, hidden, reverse, h0, c0)
    return (out, (h_t, c_t)) if return_state else out


def phase_split(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int,
                reverse: bool = False) -> dict:
    """Mean clock64() cycles per step of K2's phases, over the blocks and
    steps 1..T-1 of one launch: barrier wait, staging of h_{t-1}, product,
    and the rest (partial sums, gates, stores, arrival). For measurement;
    the launch is counted."""
    t = xw.shape[1]
    plan = lstm_plan(hidden, xw.element_size())
    if plan is None:
        raise ValueError(f"lstm phases: hidden {hidden} ({xw.dtype}) takes "
                         f"the plain route, which records no phases")
    phases = torch.zeros((plan.blocks, 4), dtype=torch.int64,
                         device=xw.device)
    lstm_fused(xw, w_hh, hidden, reverse, phases=phases)
    mean = (phases.double().mean(dim=0) / max(t - 1, 1)).tolist()
    return dict(zip(("wait", "stage", "product", "gates"), mean))


lstm_fused.launches = 0
lstm_fused.plain_routes = 0
# the counters' owner, kept apart from the module attribute that a
# measurement may swap for lstm_plain
_COUNTS = lstm_fused
