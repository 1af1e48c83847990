"""One LSTM layer's recurrence over precomputed input projections.

Counterpart of avvad_tpu/ops/lstm_pallas.py:387 ``lstm_layer_fused`` and
its custom VJP (``_make_lstm_vjp``). On a CUDA tensor each wrapper
launches its hand-written kernel or raises; on a CPU tensor it runs its
plain version, the same arithmetic in plain PyTorch. The inference and
probe kernels (``csrc/lstm_recurrence.cu``) are one launch per time step.
The two training kernels are one cooperative launch per layer
(``csrc/lstm_persistent.cu``: the weight slice stays in shared memory and
a grid barrier separates the steps) wherever ``persistent_plan`` fits the
shape on the card; elsewhere they are the per-step kernels of
``csrc/lstm_recurrence.cu`` and ``csrc/lstm_train.cu``.
The Pallas batch padding to 8/32 rows is a TPU tiling rule: rows are
independent, so the port runs the batch as given.

Kernels (see the source note in the .cu files for bounds and design):

===================  ==========================  ======================================
variant              kernel                      replaces (avvad_tpu/ops/lstm_pallas.py)
===================  ==========================  ======================================
"none"               ``lstm_f32h``               ``_lstm_kernel`` via ``_fwd_infer_call``
"bf16"               ``lstm_bf16h``              ``_lstm_kernel_hbf16`` via ``_fwd_quant_call``
"int8"               ``lstm_int8``               ``_lstm_kernel_int8`` via ``_fwd_quant_call``
"fwd_train_persist"  ``lstm_fwd_train_persist``  ``_lstm_fwd_train_kernel`` via ``_fwd_train_call``
"bwd_persist"        ``lstm_bwd_persist``        ``_lstm_bwd_kernel`` via ``_bwd_call``
"fwd_train"          ``lstm_fwd_train_f32h``     the same, per step: shapes outside the plan
"bwd"                ``lstm_bwd_f32h``           the same, per step: shapes outside the plan
"probe"              ``lstm_probe``              the probe kernel of scripts/bench_lstm_probe.py:71
===================  ==========================  ======================================

Under autograd (grad enabled and an input that requires it)
``lstm_layer_fused`` runs ``LSTMRecurrence``: its forward is the
training forward (K1d), which also keeps c_t and the activated gates, and
its backward the reverse-time kernel (K1e), with dW_hh as one fp32 matmul
outside, as
JAX's custom VJP computes it. Layouts are batch-major (B, T, ...)
throughout; the JAX kernels take time-major arrays.

``lstm_probe`` is the measuring tool's kernel (``tools/lstm_probe.py``):
the recurrence in four modes that take a step's cost apart ("full",
"h_bf16", "gates_only", "matmul_only"; ``PROBE_MODES``).
"""

from __future__ import annotations

import torch

from .qparams import weight_qparams

STATE_QUANTS = ("none", "bf16", "int8")
TRAIN_KERNELS = ("fwd_train_persist", "bwd_persist", "fwd_train", "bwd")
PROBE_MODES = ("full", "h_bf16", "gates_only", "matmul_only")  # the C entry's codes
KERNEL_NAMES = {"none": "lstm_f32h", "bf16": "lstm_bf16h", "int8": "lstm_int8",
                "fwd_train_persist": "lstm_fwd_train_persist",
                "bwd_persist": "lstm_bwd_persist",
                "fwd_train": "lstm_fwd_train_f32h", "bwd": "lstm_bwd_f32h",
                "probe": "lstm_probe"}

# Kernel launches per variant, counted by the CUDA wrappers only. A
# persistent kernel is one launch a layer, a per-step one T (or T + 1).
launches = {k: 0 for k in KERNEL_NAMES}

# Geometry of the persistent training kernels (csrc/lstm_persistent.cu)
PERSIST_UNITS = 16     # hidden units a CTA owns for the whole sequence
PERSIST_ROWS = 8       # batch rows per tile; tiles are dealt to row slices
PERSIST_CHUNK = 512    # contraction columns per chunk of the staging ring
PERSIST_STAGES = 3     # chunks in the ring
# k-groups a CTA splits the contraction over; their partials (8 rows x 64
# columns, rows padded to 80 floats, forward; 8 x 16 backward) are reduced
# through shared memory once a step
PERSIST_K_GROUPS = {"fwd_train_persist": 16, "bwd_persist": 64}
_PERSIST_PARTIAL_ROW = {"fwd_train_persist": 80, "bwd_persist": 16}
# dynamic shared memory a block may opt in to on sm_90, the only target
SMEM_LIMIT_SM90 = 232448


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def persistent_plan(b: int, h: int, sm_count: int,
                    smem_limit: int = SMEM_LIMIT_SM90) -> dict | None:
    """The persistent training kernels' plan for a (B, ., H) layer on a
    card with ``sm_count`` SMs and ``smem_limit`` bytes of shared memory a
    block, or None where the shape does not fit and the per-step kernels
    run. The grid is unit slices x row slices: CTA (x, r) owns hidden units
    [16 x, min(16 x + 16, H)) of the 8-row batch tiles r, r + slices, ...,
    with its slice of the weight (128 H bytes in both kernels) resident
    beside the staging ring, the k-groups' partials and the state of its
    cells. The barrier needs every CTA resident at once, and the plan
    counts one CTA an SM (a second fits an SM's shared memory only below
    H = 192): it fits iff H % 4 == 0 (16-byte rows), ceil(H / 16) <= sm_count
    and the shared memory is within the limit (H <= 1100 at B=16 on a
    132-SM H100). The row slices are as many as the card holds beside each
    other, at most one a tile.
    -> {"units", "rows", "grid": (unit slices, row slices), "smem_bytes":
    {variant: bytes}}."""
    if b < 1 or h < 4 or h % 4:
        return None
    unit_slices = -(-h // PERSIST_UNITS)
    tiles = -(-b // PERSIST_ROWS)
    slices = min(tiles, sm_count // unit_slices)
    if slices < 1:
        return None
    ring = PERSIST_STAGES * PERSIST_ROWS * (PERSIST_CHUNK + 8) * 4
    state = -(-tiles // slices) * PERSIST_ROWS * PERSIST_UNITS * 4
    smem = {v: 128 * h + ring + kg * PERSIST_ROWS * _PERSIST_PARTIAL_ROW[v] * 4 + state
            for v, kg in PERSIST_K_GROUPS.items()}
    if max(smem.values()) > smem_limit:
        return None
    return {"units": PERSIST_UNITS, "rows": PERSIST_ROWS, "grid": (unit_slices, slices),
            "smem_bytes": smem}


def _persistent(dev: torch.device, b: int, h: int) -> bool:
    """Whether the persistent kernels take a (B, ., H) layer on this card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return persistent_plan(b, h, sms) is not None


def _barrier(dev: torch.device, b: int) -> torch.Tensor:
    """The barriers' counters for one launch: zeroed 32-bit words, one a
    batch tile (a row slice uses one)."""
    return torch.zeros(-(-b // PERSIST_ROWS), dtype=torch.int32, device=dev)


def _check_args(x_proj, w_hh, h0, c0, state_quant):
    if state_quant not in STATE_QUANTS:
        raise ValueError(f"state_quant {state_quant!r}")
    if x_proj.ndim != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be (B, T, 4H), got {tuple(x_proj.shape)}")
    b, _, h4 = x_proj.shape
    h = h4 // 4
    if tuple(w_hh.shape) != (h, h4):
        raise ValueError(f"w_hh must be ({h}, {h4}), got {tuple(w_hh.shape)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if s is not None and tuple(s.shape) != (b, h):
            raise ValueError(f"{name} must be ({b}, {h}), got {tuple(s.shape)}")


def _quant_weights(w_hh: torch.Tensor):
    """-> (Wq int8 (H, 4H), ws = w_scale / 127 float32 (4H,))."""
    wq, w_scale = weight_qparams(w_hh.float())
    return wq, (w_scale / 127.0).float()


def _bf16_rounded(w: torch.Tensor) -> torch.Tensor:
    """The weight the kernels read (the Pallas kernels' w_dtype), in fp32."""
    return w.float().to(torch.bfloat16).float()


def _initial_state(xp, h0, c0):
    b, _, h4 = xp.shape
    zeros = lambda: torch.zeros(b, h4 // 4, device=xp.device)  # noqa: E731
    return (zeros() if h0 is None else h0.float(),
            zeros() if c0 is None else c0.float())


def _scan(xp, rec, hh, cc, residuals: bool):
    """The forward recurrence over xp (B, T, 4H) from (hh, cc), with
    ``rec(h) -> h . W_hh`` -> y, or (y, c_seq, gates) with ``residuals``."""
    b, t, h4 = xp.shape
    h = h4 // 4
    y = xp.new_empty(b, t, h)
    if residuals:
        c_seq, gates = xp.new_empty(b, t, h), xp.new_empty(b, t, h4)
    for step in range(t):
        i, f, g, o = (xp[:, step] + rec(hh)).split(h, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        cc = f * cc + i * g
        hh = o * torch.tanh(cc)
        y[:, step] = hh
        if residuals:
            c_seq[:, step] = cc
            gates[:, step] = torch.cat([i, f, g, o], dim=-1)
    return (y, c_seq, gates) if residuals else y


def lstm_layer_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                     h0: torch.Tensor | None = None,
                     c0: torch.Tensor | None = None,
                     state_quant: str = "none") -> torch.Tensor:
    """Plain PyTorch version of the inference kernels: same numerics, any
    device. Not for autograd: it rounds W_hh for the product (and the
    gradient with it); ``lstm_layer_fused`` takes gradients through
    ``LSTMRecurrence``."""
    _check_args(x_proj, w_hh, h0, c0, state_quant)
    xp = x_proj.float()
    hh, cc = _initial_state(xp, h0, c0)
    if state_quant == "int8":
        wq, ws = _quant_weights(w_hh)
        # |acc| <= 127 * 127 * H: exact in float64 for any realistic H
        wq64 = wq.to(torch.float64)

        def rec(hv):
            qh = torch.round(hv * 127.0).to(torch.int8)
            return (qh.to(torch.float64) @ wq64).float() * ws
    else:
        wd = _bf16_rounded(w_hh)

        if state_quant == "bf16":
            def rec(hv):
                return hv.to(torch.bfloat16).float() @ wd
        else:
            def rec(hv):
                return hv @ wd
    return _scan(xp, rec, hh, cc, residuals=False)


def lstm_fwd_train_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                         h0: torch.Tensor | None = None,
                         c0: torch.Tensor | None = None) -> tuple:
    """Plain version of ``lstm_fwd_train_f32h`` (K1d): fp32 h x the
    bf16-rounded W_hh -> (y (B, T, H), c_seq (B, T, H), gates (B, T, 4H)),
    the gates activated [sig(i), sig(f), tanh(g), sig(o)]."""
    _check_args(x_proj, w_hh, h0, c0, "none")
    xp = x_proj.float()
    wd = _bf16_rounded(w_hh)
    return _scan(xp, lambda hv: hv @ wd, *_initial_state(xp, h0, c0),
                 residuals=True)


def _check_bwd_args(dy, gates, c_seq, c_prev, w_hh):
    if gates.ndim != 3 or gates.shape[-1] % 4:
        raise ValueError(f"gates must be (B, T, 4H), got {tuple(gates.shape)}")
    b, t, h4 = gates.shape
    for name, a in (("dy", dy), ("c_seq", c_seq), ("c_prev", c_prev)):
        if tuple(a.shape) != (b, t, h4 // 4):
            raise ValueError(f"{name} must be ({b}, {t}, {h4 // 4}), got "
                             f"{tuple(a.shape)}")
    if tuple(w_hh.shape) != (h4 // 4, h4):
        raise ValueError(f"w_hh must be ({h4 // 4}, {h4}), got {tuple(w_hh.shape)}")


def lstm_bwd_plain(dy: torch.Tensor, gates: torch.Tensor, c_seq: torch.Tensor,
                   c_prev: torch.Tensor, w_hh: torch.Tensor) -> tuple:
    """Plain version of ``lstm_bwd_f32h`` (K1e): the reverse-time gradient
    recurrence of ``_lstm_bwd_kernel`` (lstm_pallas.py:138-178), step by
    step, with the bf16-rounded W^T and fp32 products. dy, c_seq, c_prev
    (B, T, H), gates (B, T, 4H) activated -> (d_gates (B, T, 4H)
    pre-activation, dh0 (B, H), dc0 (B, H))."""
    _check_bwd_args(dy, gates, c_seq, c_prev, w_hh)
    b, t, h4 = gates.shape
    h = h4 // 4
    wt = _bf16_rounded(w_hh).t()
    dh_next = gates.new_zeros(b, h, dtype=torch.float32)
    dc_next = torch.zeros_like(dh_next)
    d_gates = torch.empty(b, t, h4, device=gates.device)
    for step in reversed(range(t)):
        i, f, g, o = gates[:, step].float().split(h, dim=-1)
        tanh_c = torch.tanh(c_seq[:, step].float())
        dh = dy[:, step].float() + dh_next
        do = dh * tanh_c
        dc = dh * o * (1.0 - tanh_c * tanh_c) + dc_next
        di = dc * g
        df = dc * c_prev[:, step].float()
        dg = dc * i
        d_pre = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                           dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        d_gates[:, step] = d_pre
        dh_next = d_pre @ wt
        dc_next = dc * f
    return d_gates, dh_next, dc_next


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_device(name: str, a: torch.Tensor, dev: torch.device) -> None:
    _require(a.device == dev and a.dtype == torch.float32 and a.is_contiguous(),
             f"{name} must be contiguous float32 on the CUDA device {dev}")


def _run(variant: str, dev: torch.device, fn, *args) -> None:
    """Call a C entry point with the tensors' card current and the stream
    last; raise on its CUDA error."""
    # temporaries the caller frees live on this stream too, so the caching
    # allocator reuses their memory only after the queued launches
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the C library launches on the current card
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL_NAMES[variant]} launch failed: cudaError {rc}")


def _launch(x_proj, w_hh, h0, c0, variant):
    """Forward kernels: "none" / "bf16" / "int8" -> y; "fwd_train" and
    "fwd_train_persist" -> (y, c_seq, gates)."""
    from ._build import kernel_lib

    dev = x_proj.device
    b, t, h4 = x_proj.shape
    h = h4 // 4
    _on_device("x_proj", x_proj, dev)
    _require(w_hh.device == dev, "w_hh must lie on x_proj's device")
    h0 = torch.zeros(b, h, device=dev) if h0 is None else h0
    c = (torch.zeros(b, h, device=dev) if c0 is None
         else c0.to(torch.float32).clone())  # updated in place by the kernel
    _on_device("h0", h0, dev)
    _on_device("c0", c, dev)
    y = torch.empty(b, t, h, device=dev)
    persist = variant == "fwd_train_persist"
    train = persist or variant == "fwd_train"
    if train:
        c_seq = torch.empty(b, t, h, device=dev)
        gates = torch.empty(b, t, h4, device=dev)
    out = (y, c_seq, gates) if train else y
    if t == 0 or b == 0:
        return out
    lib = kernel_lib()
    if variant == "int8":
        _require(h % 4 == 0, f"int8 recurrence needs H % 4 == 0, got H={h}")
        wq, ws = _quant_weights(w_hh)
        # pack four consecutive k of each column into one int32 for __dp4a
        wp = (wq.reshape(h // 4, 4, h4).permute(0, 2, 1).contiguous()
              .view(torch.int32).reshape(h // 4, h4))
        _run(variant, dev, lib.lstm_int8, x_proj.data_ptr(), wp.data_ptr(),
             ws.data_ptr(), h0.data_ptr(), c.data_ptr(), y.data_ptr(), b, t, h)
    else:
        w = w_hh.to(torch.bfloat16).contiguous()
        ptrs = [x_proj.data_ptr(), w.data_ptr(), h0.data_ptr(), c.data_ptr(),
                y.data_ptr()]
        if train:
            ptrs += [c_seq.data_ptr(), gates.data_ptr()]
        if persist:
            bar = _barrier(dev, b)
            ptrs.append(bar.data_ptr())
        _run(variant, dev, getattr(lib, KERNEL_NAMES[variant]), *ptrs, b, t, h)
    launches[variant] += 1 if persist else t
    return out


def lstm_fwd_train(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   h0: torch.Tensor | None = None,
                   c0: torch.Tensor | None = None) -> tuple:
    """K1d: the forward of training -> (y, c_seq, gates), as
    ``lstm_fwd_train_plain``. A CUDA ``x_proj`` launches
    ``lstm_fwd_train_persist`` once where ``persistent_plan`` fits the
    shape on its card, else ``lstm_fwd_train_f32h`` T times, or raises; a
    CPU one runs the plain version."""
    _check_args(x_proj, w_hh, h0, c0, "none")
    if x_proj.is_cuda:
        b, _, h4 = x_proj.shape
        return _launch(x_proj, w_hh, h0, c0,
                       "fwd_train_persist" if _persistent(x_proj.device, b, h4 // 4)
                       else "fwd_train")
    return lstm_fwd_train_plain(x_proj, w_hh, h0, c0)


def lstm_bwd(dy: torch.Tensor, gates: torch.Tensor, c_seq: torch.Tensor,
             c_prev: torch.Tensor, w_hh: torch.Tensor) -> tuple:
    """K1e: the reverse-time backward -> (d_gates, dh0, dc0), as
    ``lstm_bwd_plain``. CUDA ``gates`` launch ``lstm_bwd_persist`` once
    (the T steps and the dh0 contraction) where ``persistent_plan`` fits
    the shape on their card, else ``lstm_bwd_f32h`` T + 1 times, or raise;
    CPU ones run the plain version."""
    _check_bwd_args(dy, gates, c_seq, c_prev, w_hh)
    if not gates.is_cuda:
        return lstm_bwd_plain(dy, gates, c_seq, c_prev, w_hh)
    from ._build import kernel_lib

    dev = gates.device
    b, t, h4 = gates.shape
    h = h4 // 4
    for name, a in (("dy", dy), ("gates", gates), ("c_seq", c_seq),
                    ("c_prev", c_prev)):
        _on_device(name, a, dev)
    _require(w_hh.device == dev, "w_hh must lie on gates' device")
    # W^T (4H, H) in bf16, as jnp.transpose(w_hh).astype(w_dtype)
    wt = w_hh.t().to(torch.bfloat16).contiguous()
    d_gates = torch.empty(b, t, h4, device=dev)
    dh0 = torch.zeros(b, h, device=dev)
    dc = torch.zeros(b, h, device=dev)  # dc_{t+1}, in place; dc0 on return
    if t == 0 or b == 0:
        return d_gates, dh0, dc
    ptrs = [dy.data_ptr(), gates.data_ptr(), c_seq.data_ptr(), c_prev.data_ptr(),
            wt.data_ptr(), d_gates.data_ptr(), dh0.data_ptr(), dc.data_ptr()]
    if _persistent(dev, b, h):
        bar = _barrier(dev, b)
        _run("bwd_persist", dev, kernel_lib().lstm_bwd_persist, *ptrs,
             bar.data_ptr(), b, t, h)
        launches["bwd_persist"] += 1
    else:
        _run("bwd", dev, kernel_lib().lstm_bwd_f32h, *ptrs, b, t, h)
        launches["bwd"] += t + 1
    return d_gates, dh0, dc


def _check_probe_args(x_proj, w_hh, h0, c0, mode):
    if mode not in PROBE_MODES:
        raise ValueError(f"probe mode {mode!r}: one of {PROBE_MODES}")
    _check_args(x_proj, w_hh, h0, c0, "none")


def lstm_probe_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                     h0: torch.Tensor | None = None,
                     c0: torch.Tensor | None = None,
                     mode: str = "full") -> torch.Tensor:
    """Plain version of ``lstm_probe`` (scripts/bench_lstm_probe.py:71-95),
    batch-major: x_proj (B, T, 4H) -> y (B, T, H) float32, W_hh rounded to
    bf16. "full": gates = xp + h fp32 . W; "h_bf16": h rounded to bf16 for
    the dot; "gates_only": gates = xp, no product; "matmul_only": gates as
    in "full", then h = gates[:, :H] (the pre-activation i columns) and c
    unchanged."""
    _check_probe_args(x_proj, w_hh, h0, c0, mode)
    if mode == "full":
        return lstm_layer_plain(x_proj, w_hh, h0, c0, "none")
    if mode == "h_bf16":
        return lstm_layer_plain(x_proj, w_hh, h0, c0, "bf16")
    xp = x_proj.float()
    hh, cc = _initial_state(xp, h0, c0)
    if mode == "gates_only":
        return _scan(xp, lambda hv: 0.0, hh, cc, residuals=False)
    wd = _bf16_rounded(w_hh)
    h = wd.shape[0]
    y = xp.new_empty(xp.shape[0], xp.shape[1], h)
    for step in range(xp.shape[1]):
        hh = (xp[:, step] + hh @ wd)[:, :h]
        y[:, step] = hh
    return y


def lstm_probe(x_proj: torch.Tensor, w_hh: torch.Tensor,
               h0: torch.Tensor | None = None, c0: torch.Tensor | None = None,
               mode: str = "full") -> torch.Tensor:
    """The probe kernel: one layer's recurrence in one of ``PROBE_MODES``
    -> y (B, T, H), as ``lstm_probe_plain``. Batch-major like the other
    wrappers here (the TPU kernel is time-major). A CUDA ``x_proj``
    launches ``lstm_probe`` T times, counted under ``launches["probe"]``
    whatever the mode, or raises; a CPU one runs the plain version. Not
    for autograd."""
    _check_probe_args(x_proj, w_hh, h0, c0, mode)
    if not x_proj.is_cuda:
        return lstm_probe_plain(x_proj, w_hh, h0, c0, mode)
    from ._build import kernel_lib

    dev = x_proj.device
    b, t, h4 = x_proj.shape
    h = h4 // 4
    _on_device("x_proj", x_proj, dev)
    _require(w_hh.device == dev, "w_hh must lie on x_proj's device")
    h0 = torch.zeros(b, h, device=dev) if h0 is None else h0
    c = (torch.zeros(b, h, device=dev) if c0 is None
         else c0.to(torch.float32).clone())  # updated in place by the kernel
    _on_device("h0", h0, dev)
    _on_device("c0", c, dev)
    y = torch.empty(b, t, h, device=dev)
    if t == 0 or b == 0:
        return y
    w = w_hh.to(torch.bfloat16).contiguous()
    # "matmul_only" parks the three gate sums it does not use here, so that
    # the whole (B, H) x (H, 4H) product stays in the kernel
    scratch = torch.empty(b, h4, device=dev)
    _run("probe", dev, kernel_lib().lstm_probe, x_proj.data_ptr(), w.data_ptr(),
         h0.data_ptr(), c.data_ptr(), y.data_ptr(), scratch.data_ptr(), b, t, h,
         PROBE_MODES.index(mode))
    launches["probe"] += t
    return y


class LSTMRecurrence(torch.autograd.Function):
    """The recurrence with JAX's custom VJP (lstm_pallas.py:351-382) over
    (x_proj, w_hh, h0, c0), all given. The forward runs K1d and keeps
    (w_hh, h0, c0, y, c_seq, gates); the backward runs K1e, then
    dW_hh = h_prev^T d_gates as one fp32 matmul over the B*T rows with
    TF32 off (JAX: an einsum at Precision.HIGHEST, outside any kernel);
    dx_proj = d_gates. The kernels read W_hh rounded to bf16; its gradient
    stays fp32. Each wrapper runs its plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0):
        y, c_seq, gates = lstm_fwd_train(x_proj, w_hh, h0, c0)
        ctx.save_for_backward(w_hh, h0, c0, y, c_seq, gates)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        w_hh, h0, c0, y, c_seq, gates = ctx.saved_tensors
        h = h0.shape[-1]
        c_prev = torch.cat([c0[:, None], c_seq[:, :-1]], dim=1)
        d_gates, dh0, dc0 = lstm_bwd(dy.float().contiguous(), gates, c_seq,
                                     c_prev, w_hh)
        dw_hh = None
        if ctx.needs_input_grad[1]:
            h_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                dw_hh = h_prev.reshape(-1, h).t() @ d_gates.reshape(-1, 4 * h)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            dw_hh = dw_hh.to(w_hh.dtype)
        return d_gates, dw_hh, dh0, dc0


def lstm_layer_fused(x_proj: torch.Tensor, w_hh: torch.Tensor,
                     h0: torch.Tensor | None = None,
                     c0: torch.Tensor | None = None,
                     state_quant: str = "none") -> torch.Tensor:
    """Run one LSTM layer: x_proj (B, T, 4H) = x @ W_ih + b, w_hh (H, 4H)
    in gate order [i, f, g, o] -> hidden states (B, T, H) float32.

    state_quant: "none" (fp32 h x bf16-rounded W_hh), "bf16" (h rounded to
    bf16 for the dot) or "int8" (W8A8 with h on the fixed scale 127, W_hh
    per-column int8). Under autograd (grad enabled, an input requires it)
    "none" runs ``LSTMRecurrence`` (K1d forward, K1e backward) and the
    quantised variants raise NotImplementedError, as in JAX; otherwise
    the inference kernel runs. A CUDA ``x_proj`` launches the kernels (or
    raises); a CPU ``x_proj`` runs their plain versions."""
    _check_args(x_proj, w_hh, h0, c0, state_quant)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (x_proj, w_hh, h0, c0)):
        if state_quant != "none":
            raise NotImplementedError(
                f"lstm state_quant={state_quant!r} is inference-only; unset "
                "state_quant (or use the default Pallas kernel) for training")
        h0, c0 = _initial_state(x_proj, h0, c0)
        return LSTMRecurrence.apply(x_proj, w_hh, h0, c0)
    if x_proj.is_cuda:
        return _launch(x_proj, w_hh, h0, c0, state_quant)
    return lstm_layer_plain(x_proj, w_hh, h0, c0, state_quant)
