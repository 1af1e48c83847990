"""One LSTM layer's recurrence over precomputed input projections.

Counterpart of avvad_tpu/ops/lstm_pallas.py:387 ``lstm_layer_fused`` and
its custom VJP (``_make_lstm_vjp``). On a CUDA tensor each wrapper
launches its hand-written kernel or raises; on a CPU tensor it runs its
plain version, the same arithmetic in plain PyTorch. The three inference
kernels and the two training kernels are one cooperative launch per layer
(``csrc/lstm_persistent.cu``: the weight slice stays in shared memory and
grid barriers separate the steps) wherever ``persistent_plan`` fits the
shape on the card; elsewhere they are the per-step kernels of
``csrc/lstm_recurrence.cu`` and ``csrc/lstm_train.cu``, one launch per
time step. The probe kernel takes the same two routes.
The Pallas batch padding to 8/32 rows is a TPU tiling rule: rows are
independent, so the port runs the batch as given.

Kernels (see the source note in the .cu files for bounds and design):

===================  ==========================  ======================================
variant              kernel                      replaces (avvad_tpu/ops/lstm_pallas.py)
===================  ==========================  ======================================
"none_persist"       ``lstm_f32h_persist``       ``_lstm_kernel`` via ``_fwd_infer_call``
"none"               ``lstm_f32h``               the same, per step: shapes outside the plan
"bf16_persist"       ``lstm_bf16h_persist``      ``_lstm_kernel_hbf16`` via ``_fwd_quant_call``
"bf16"               ``lstm_bf16h``              the same, per step: shapes outside the plan
"int8_persist"       ``lstm_int8_persist``       ``_lstm_kernel_int8`` via ``_fwd_quant_call``
"int8"               ``lstm_int8``               the same, per step: shapes outside the plan
"fwd_train_persist"  ``lstm_fwd_train_persist``  ``_lstm_fwd_train_kernel`` via ``_fwd_train_call``
"bwd_persist"        ``lstm_bwd_persist``        ``_lstm_bwd_kernel`` via ``_bwd_call``
"fwd_train"          ``lstm_fwd_train_f32h``     the same, per step: shapes outside the plan
"bwd"                ``lstm_bwd_f32h``           the same, per step: shapes outside the plan
"probe_persist"      ``lstm_probe_persist``      the probe kernel of scripts/bench_lstm_probe.py:71
"probe"              ``lstm_probe``              the same, per step: shapes outside the plan
===================  ==========================  ======================================

Under autograd (grad enabled and an input that requires it)
``lstm_layer_fused`` runs ``LSTMRecurrence``: its forward is the
training forward (K1d), which also keeps c_t and the activated gates, and
its backward the reverse-time kernel (K1e), with dW_hh as one fp32 matmul
outside, as
JAX's custom VJP computes it. Layouts are batch-major (B, T, ...)
throughout; the JAX kernels take time-major arrays.

The inference route is the custom op ``avvad_tpu_torch::lstm_infer``
(``torch.library``): its CUDA implementation picks the variant from
``state_quant`` by ``infer_variant`` when it runs and launches the kernel;
its CPU implementation is ``lstm_layer_plain``; its fake implementation
gives the output's shape, so ``torch.export`` records the op in a serving
program (``export.ServingArtifact``) as the JAX artifact records its Mosaic
custom call. The training kernels (K1d, K1e) and the probe are no custom
ops: training is not exported, and the probe is a measuring tool.

``lstm_probe`` is the measuring tool's kernel (``tools/lstm_probe.py``):
the recurrence in four modes that take a step's cost apart ("full",
"h_bf16", "gates_only", "matmul_only"; ``PROBE_MODES``), as compile-time
variants of the inference kernel that serving runs at the shape
(``probe_variant``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .qparams import weight_qparams

STATE_QUANTS = ("none", "bf16", "int8")
TRAIN_KERNELS = ("fwd_train_persist", "bwd_persist", "fwd_train", "bwd")
PROBE_MODES = ("full", "h_bf16", "gates_only", "matmul_only")  # the C entry's codes
KERNEL_NAMES = {"none_persist": "lstm_f32h_persist",
                "none": "lstm_f32h", "bf16_persist": "lstm_bf16h_persist",
                "bf16": "lstm_bf16h", "int8_persist": "lstm_int8_persist",
                "int8": "lstm_int8",
                "fwd_train_persist": "lstm_fwd_train_persist",
                "bwd_persist": "lstm_bwd_persist",
                "fwd_train": "lstm_fwd_train_f32h", "bwd": "lstm_bwd_f32h",
                "probe_persist": "lstm_probe_persist", "probe": "lstm_probe"}

# Kernel launches per variant, counted by the CUDA wrappers only. A
# persistent kernel is one launch a layer, a per-step one T (or T + 1).
launches = {k: 0 for k in KERNEL_NAMES}

# Geometry of the persistent kernels (csrc/lstm_persistent.cu)
PERSIST_UNITS = 16     # hidden units a CTA owns for the whole sequence
PERSIST_ROWS = 8       # batch rows per tile; tiles are dealt to row slices
PERSIST_CHUNK = 512    # contraction columns per chunk of the staging ring
PERSIST_STAGES = 3     # chunks in the ring
# k-groups a CTA splits the contraction over; their partials (8 rows x 64
# columns, rows padded to 80 floats, forward; 8 x 16 backward) are reduced
# through shared memory once a step
PERSIST_K_GROUPS = {"fwd_train_persist": 16, "bwd_persist": 64}
_PERSIST_PARTIAL_ROW = {"fwd_train_persist": 80, "bwd_persist": 16}
# where a CTA has two or more batch tiles, the inference kernel walks them
# in pairs (16 rows), with chunks of half the length and one partial a warp;
# where it has one, inference is the training forward without its stores
PERSIST_INFER_CHUNK = 256
PERSIST_INFER_K_GROUPS = 8
# the quantised-state inference kernels (tensor cores) on a grid of their
# own: a CTA owns 16 (bf16) or 32 (int8: its weight slice is half as large)
# hidden units of the 8-row batch tiles of its row slice, walked in groups of
# 512 / units rows (2 cells a thread); the exchange rows and weight columns
# are the H elements padded with zeros to a multiple of the 32-byte k step
# (and 16 bytes between columns); the ring holds four chunks of 512 bytes a
# row (16 between rows), and between a group's last chunk and the next group
# the partials of 8 warps / (units / 8) k-groups (rows of 4 units + 8 words)
QUANT_ELEMENT_BYTES = {"bf16_persist": 2, "int8_persist": 1}
PERSIST_QUANT_UNITS = {"bf16_persist": 16, "int8_persist": 32}
PERSIST_QUANT_CHUNK = 512
PERSIST_QUANT_STAGES = 4
# dynamic shared memory a block may opt in to on sm_90, the only target
SMEM_LIMIT_SM90 = 232448


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def quant_row_bytes(h: int, variant: str) -> int:
    """Bytes of a padded row of a quantised kernel's exchange (and of a
    weight column in its shared memory): H elements up to a multiple of 32."""
    return -(-h * QUANT_ELEMENT_BYTES[variant] // 32) * 32


def quant_group_rows(variant: str) -> int:
    """Rows of a group of batch tiles in a quantised kernel: 2 cells a thread."""
    return 2 * 256 // PERSIST_QUANT_UNITS[variant]


def quant_k_groups(variant: str) -> int:
    """k-groups of a quantised kernel's product: 8 warps over 32-column groups."""
    return 8 // (4 * PERSIST_QUANT_UNITS[variant] // 32)


def persistent_plan(b: int, h: int, sm_count: int,
                    smem_limit: int = SMEM_LIMIT_SM90) -> dict | None:
    """The persistent kernels' plan for a (B, ., H) layer on a
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
    {variant: bytes}, "infer": whether ``lstm_f32h_persist`` takes the shape
    too, "infer_pairs": whether it walks batch tiles in pairs (a CTA has
    two or more) or runs the training forward without its residual stores
    (one tile a CTA), "infer_smem_bytes", "quant_grid" and
    "quant_smem_bytes": {"bf16_persist" / "int8_persist": the quantised-state
    kernels' grid (unit slices of ``PERSIST_QUANT_UNITS``, row slices) and
    shared memory}, "infer_bf16" / "infer_int8": whether each takes the
    shape}."""
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
    pairs = tiles > slices
    pair_rows = 2 * PERSIST_ROWS
    infer_smem = smem["fwd_train_persist"] if not pairs else (
        128 * h + PERSIST_STAGES * pair_rows * (PERSIST_INFER_CHUNK + 8) * 4
        + PERSIST_INFER_K_GROUPS * pair_rows * _PERSIST_PARTIAL_ROW["fwd_train_persist"] * 4
        + state)
    quant_grid, quant = {}, {}
    for v, units in PERSIST_QUANT_UNITS.items():
        gx = -(-h // units)
        gy = min(tiles, sm_count // gx)
        quant_grid[v] = (gx, gy)
        quant[v] = (4 * units * (quant_row_bytes(h, v) + 16)
                    + PERSIST_QUANT_STAGES * quant_group_rows(v) * (PERSIST_QUANT_CHUNK + 16)
                    + -(-tiles // gy) * PERSIST_ROWS * units * 4)
    return {"units": PERSIST_UNITS, "rows": PERSIST_ROWS, "grid": (unit_slices, slices),
            "smem_bytes": smem, "infer": infer_smem <= smem_limit, "infer_pairs": pairs,
            "infer_smem_bytes": infer_smem, "quant_grid": quant_grid, "quant_smem_bytes": quant,
            "infer_bf16": quant["bf16_persist"] <= smem_limit,
            "infer_int8": quant["int8_persist"] <= smem_limit}


def _persistent(dev: torch.device, b: int, h: int) -> bool:
    """Whether the persistent kernels take a (B, ., H) layer on this card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return persistent_plan(b, h, sms) is not None


def infer_variant(state_quant: str, b: int, h: int, sm_count: int) -> str:
    """The inference kernel of ``state_quant`` for a (B, ., H) layer on a
    card with ``sm_count`` SMs: the persistent one where ``persistent_plan``
    takes the shape and that kernel's shared memory fits, else the per-step
    one."""
    plan = persistent_plan(b, h, sm_count)
    fits = plan is not None and plan[{"none": "infer", "bf16": "infer_bf16",
                                      "int8": "infer_int8"}[state_quant]]
    return state_quant + "_persist" if fits else state_quant


def probe_variant(mode: str, b: int, h: int, sm_count: int) -> str:
    """The probe's route for a (B, ., H) layer on a card with ``sm_count``
    SMs: "probe_persist" where the persistent inference kernel whose
    arithmetic the mode takes apart runs the shape (``lstm_bf16h_persist``
    for "h_bf16", ``lstm_f32h_persist`` for the others: ``infer_variant``),
    else the per-step "probe"."""
    sq = "bf16" if mode == "h_bf16" else "none"
    return "probe_persist" if infer_variant(sq, b, h, sm_count) == sq + "_persist" else "probe"


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


# cudaErrorCooperativeLaunchTooLarge: the grid cannot be resident at once
_COOPERATIVE_TOO_LARGE = 720


def _launch_error(variant: str, rc: int, dev: torch.device, b: int, h: int,
                  geometry: str | None = None) -> str:
    """What to tell the caller when a C entry point returned ``rc``;
    ``geometry``: the variant whose grid the launch had, where not its own
    (the persistent probe runs the grid of "none_persist" or "bf16_persist")."""
    msg = f"{KERNEL_NAMES[variant]} launch failed: cudaError {rc}"
    if not variant.endswith("_persist"):
        return msg
    variant = geometry or variant
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = persistent_plan(b, h, sms)
    if plan is None:
        return msg + f"; persistent_plan({b}, {h}, {sms}) refuses this shape"
    if variant in QUANT_ELEMENT_BYTES:
        grid, smem = plan["quant_grid"][variant], plan["quant_smem_bytes"][variant]
    else:
        grid = plan["grid"]
        smem = (plan["infer_smem_bytes"] if variant == "none_persist"
                else plan["smem_bytes"][variant])
    msg += (f"; a cooperative launch of {grid[0]} x {grid[1]} blocks of "
            f"256 threads with {smem} bytes of shared memory each, one an SM on "
            f"{sms} SMs, all resident at once")
    if rc == _COOPERATIVE_TOO_LARGE:
        msg += (": the card cannot hold the grid now, most likely because another "
                "process or another stream's kernel occupies some of its SMs")
    return msg


def _run(variant: str, dev: torch.device, fn, *args, geometry: str | None = None) -> None:
    """Call a C entry point with the tensors' card current and the stream
    last; raise on its CUDA error (no second route). The arguments end
    ``B, T, H`` (or ``B, T, H, mode``)."""
    # temporaries the caller frees live on this stream too, so the caching
    # allocator reuses their memory only after the queued launches
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the C library launches on the current card
        rc = fn(*args, stream)
    if rc != 0:
        b, _, h = args[-4:-1] if variant.startswith("probe") else args[-3:]
        raise RuntimeError(_launch_error(variant, rc, dev, b, h, geometry))


def _launch(x_proj, w_hh, h0, c0, variant):
    """Forward kernels: "none_persist" / "none" / "bf16_persist" / "bf16" /
    "int8_persist" / "int8" -> y; "fwd_train" and "fwd_train_persist" ->
    (y, c_seq, gates)."""
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
    persist = variant.endswith("_persist")
    train = variant in ("fwd_train_persist", "fwd_train")
    if train:
        c_seq = torch.empty(b, t, h, device=dev)
        gates = torch.empty(b, t, h4, device=dev)
    out = (y, c_seq, gates) if train else y
    if t == 0 or b == 0:
        return out
    lib = kernel_lib()
    if variant in QUANT_ELEMENT_BYTES:
        # the exchange of the rounded h: two rows a batch row, by step parity,
        # padded with zeros that the kernel never writes
        hx = torch.zeros(2, b, quant_row_bytes(h, variant), dtype=torch.uint8, device=dev)
        bar = _barrier(dev, b)
        if variant == "int8_persist":
            wq, ws = _quant_weights(w_hh)  # row-major (H, 4H) int8, (4H,) w_scale / 127
            weights = [wq.contiguous(), ws]
        else:
            weights = [w_hh.to(torch.bfloat16).contiguous()]
        _run(variant, dev, getattr(lib, KERNEL_NAMES[variant]), x_proj.data_ptr(),
             *(a.data_ptr() for a in weights), h0.data_ptr(), c.data_ptr(), y.data_ptr(),
             hx.data_ptr(), bar.data_ptr(), b, t, h)
    elif variant == "int8":
        wq, ws = _quant_weights(w_hh)
        # pack four consecutive k of each column into one int32 for __dp4a,
        # the last word's missing k as zero rows
        k4 = -(-h // 4)
        wq = torch.cat([wq, wq.new_zeros(4 * k4 - h, h4)])
        wp = (wq.reshape(k4, 4, h4).permute(0, 2, 1).contiguous()
              .view(torch.int32).reshape(k4, h4))
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
    -> y (B, T, H), as ``lstm_probe_plain``. It takes apart the inference
    kernel that ``lstm_layer_fused`` runs at the shape (``probe_variant``):
    where ``persistent_plan`` takes it, ``lstm_probe_persist``, one
    cooperative launch a layer, counted under ``launches["probe_persist"]``,
    whose "full" is ``lstm_f32h_persist`` and "h_bf16" ``lstm_bf16h_persist``
    bit for bit, and whose other modes are cuts of the fp32-h kernel;
    elsewhere the per-step ``lstm_probe`` (the ``lstm_f32h`` / ``lstm_bf16h``
    instantiation), T launches counted under ``launches["probe"]``.
    Batch-major like the other wrappers here (the TPU kernel is
    time-major). A CUDA ``x_proj`` launches the kernel or raises; a CPU one
    runs the plain version. Not for autograd."""
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
    ptrs = [x_proj.data_ptr(), w.data_ptr(), h0.data_ptr(), c.data_ptr(), y.data_ptr(),
            scratch.data_ptr()]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if probe_variant(mode, b, h, sms) == "probe":
        _run("probe", dev, kernel_lib().lstm_probe, *ptrs, b, t, h, PROBE_MODES.index(mode))
        launches["probe"] += t
        return y
    # "h_bf16"'s exchange of the rounded h, as lstm_bf16h_persist's
    hx = torch.zeros(2 if mode == "h_bf16" else 0, b, quant_row_bytes(h, "bf16_persist"),
                     dtype=torch.uint8, device=dev)
    bar = _barrier(dev, b)
    _run("probe_persist", dev, kernel_lib().lstm_probe_persist, *ptrs, hx.data_ptr(),
         bar.data_ptr(), b, t, h, PROBE_MODES.index(mode),
         geometry="bf16_persist" if mode == "h_bf16" else "none_persist")
    launches["probe_persist"] += 1
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


@torch.library.custom_op("avvad_tpu_torch::lstm_infer", mutates_args=(),
                         device_types="cpu")
def lstm_infer(x_proj: torch.Tensor, w_hh: torch.Tensor, h0: Optional[torch.Tensor],
               c0: Optional[torch.Tensor], state_quant: str) -> torch.Tensor:
    """One layer's inference recurrence as an op: on the CPU the plain
    version (the CUDA implementation is registered below)."""
    return lstm_layer_plain(x_proj, w_hh, h0, c0, state_quant)


@lstm_infer.register_kernel("cuda")
def _lstm_infer_cuda(x_proj, w_hh, h0, c0, state_quant):
    # the route is read here, when the op runs: the card's SMs and the plan,
    # never while a program is traced
    sms = torch.cuda.get_device_properties(x_proj.device).multi_processor_count
    return _launch(x_proj, w_hh, h0, c0, infer_variant(
        state_quant, x_proj.shape[0], x_proj.shape[2] // 4, sms))


@lstm_infer.register_fake
def _lstm_infer_fake(x_proj, w_hh, h0, c0, state_quant):
    b, t, h4 = x_proj.shape
    return x_proj.new_empty(b, t, h4 // 4, dtype=torch.float32)


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
    the op ``lstm_infer`` runs the inference kernel: ``lstm_f32h_persist``,
    ``lstm_bf16h_persist`` or ``lstm_int8_persist``, one launch a layer,
    where ``persistent_plan`` fits the shape on the card (``infer_variant``),
    else the per-step ``lstm_f32h``, ``lstm_bf16h`` or ``lstm_int8``. A CUDA
    ``x_proj`` launches the kernels (or raises); a CPU ``x_proj`` runs their
    plain versions."""
    _check_args(x_proj, w_hh, h0, c0, state_quant)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (x_proj, w_hh, h0, c0)):
        if state_quant != "none":
            raise NotImplementedError(
                f"lstm state_quant={state_quant!r} is inference-only; unset "
                "state_quant (or use the default Pallas kernel) for training")
        h0, c0 = _initial_state(x_proj, h0, c0)
        return LSTMRecurrence.apply(x_proj, w_hh, h0, c0)
    return lstm_infer(x_proj, w_hh, h0, c0, state_quant)
