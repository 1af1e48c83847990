"""One LSTM layer's recurrence over precomputed input projections.

Counterpart of avvad_tpu/ops/lstm_pallas.py:387 ``lstm_layer_fused``
(inference only). On a CUDA tensor the wrapper launches the hand-written
kernels of ``csrc/lstm_recurrence.cu`` (one launch per time step) or
raises; on a CPU tensor it runs ``lstm_layer_plain``, the same arithmetic
in plain PyTorch. The Pallas batch padding to 8/32 rows is a TPU tiling
rule: rows are independent, so the port runs the batch as given.

Kernels (see the source note in the .cu file for bounds and design):

=========  ==================  ============================================
variant    kernel              replaces (avvad_tpu/ops/lstm_pallas.py)
=========  ==================  ============================================
"none"     ``lstm_f32h``       ``_lstm_kernel`` via ``_fwd_infer_call``
"bf16"     ``lstm_bf16h``      ``_lstm_kernel_hbf16`` via ``_fwd_quant_call``
"int8"     ``lstm_int8``       ``_lstm_kernel_int8`` via ``_fwd_quant_call``
=========  ==================  ============================================
"""

from __future__ import annotations

import torch

from .qparams import weight_qparams

STATE_QUANTS = ("none", "bf16", "int8")
KERNEL_NAMES = {"none": "lstm_f32h", "bf16": "lstm_bf16h", "int8": "lstm_int8"}

# Kernel launches per variant, counted by the CUDA wrapper only.
launches = {sq: 0 for sq in STATE_QUANTS}


def reset_launches() -> None:
    for sq in STATE_QUANTS:
        launches[sq] = 0


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


def lstm_layer_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                     h0: torch.Tensor | None = None,
                     c0: torch.Tensor | None = None,
                     state_quant: str = "none") -> torch.Tensor:
    """Plain PyTorch version of the kernels: same numerics, any device."""
    _check_args(x_proj, w_hh, h0, c0, state_quant)
    xp = x_proj.float()
    b, t, h4 = xp.shape
    h = h4 // 4
    hh = torch.zeros(b, h, device=xp.device) if h0 is None else h0.float()
    cc = torch.zeros(b, h, device=xp.device) if c0 is None else c0.float()
    if state_quant == "int8":
        wq, ws = _quant_weights(w_hh)
        # |acc| <= 127 * 127 * H: exact in float64 for any realistic H
        wq64 = wq.to(torch.float64)

        def rec(hv):
            qh = torch.round(hv * 127.0).to(torch.int8)
            return (qh.to(torch.float64) @ wq64).float() * ws
    else:
        # bf16-rounded weight widened to fp32 (the Pallas kernel's w_dtype)
        wd = w_hh.float().to(torch.bfloat16).float()

        if state_quant == "bf16":
            def rec(hv):
                return hv.to(torch.bfloat16).float() @ wd
        else:
            def rec(hv):
                return hv @ wd
    ys = []
    for step in range(t):
        gates = xp[:, step] + rec(hh)
        i, f, g, o = gates.split(h, dim=-1)
        cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(g)
        hh = torch.sigmoid(o) * torch.tanh(cc)
        ys.append(hh)
    return torch.stack(ys, dim=1)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _launch(x_proj, w_hh, h0, c0, state_quant) -> torch.Tensor:
    from ._build import kernel_lib

    dev = x_proj.device
    b, t, h4 = x_proj.shape
    h = h4 // 4
    _require(x_proj.dtype == torch.float32 and x_proj.is_contiguous(),
             "x_proj must be contiguous float32 on the CUDA device")
    _require(w_hh.device == dev, "w_hh must lie on x_proj's device")
    h0 = torch.zeros(b, h, device=dev) if h0 is None else h0
    c = (torch.zeros(b, h, device=dev) if c0 is None
         else c0.to(torch.float32).clone())  # updated in place by the kernel
    for name, s in (("h0", h0), ("c0", c)):
        _require(s.device == dev and s.dtype == torch.float32
                 and s.is_contiguous(), f"{name} must be contiguous float32 "
                 "on x_proj's device")
    y = torch.empty(b, t, h, device=dev, dtype=torch.float32)
    if t == 0 or b == 0:
        return y
    # the temporaries below live on this stream too, so the caching
    # allocator reuses their memory only after the queued launches
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = kernel_lib()
    if state_quant == "int8":
        _require(h % 4 == 0, f"int8 recurrence needs H % 4 == 0, got H={h}")
        wq, ws = _quant_weights(w_hh)
        # pack four consecutive k of each column into one int32 for __dp4a
        wp = (wq.reshape(h // 4, 4, h4).permute(0, 2, 1).contiguous()
              .view(torch.int32).reshape(h // 4, h4))
        args = (x_proj.data_ptr(), wp.data_ptr(), ws.data_ptr(),
                h0.data_ptr(), c.data_ptr(), y.data_ptr(), b, t, h, stream)
        fn = lib.lstm_int8
    else:
        w = w_hh.to(torch.bfloat16).contiguous()
        args = (x_proj.data_ptr(), w.data_ptr(), h0.data_ptr(), c.data_ptr(),
                y.data_ptr(), b, t, h, stream)
        fn = lib.lstm_f32h if state_quant == "none" else lib.lstm_bf16h
    # the C library launches on the runtime's current device
    with torch.cuda.device(dev):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{KERNEL_NAMES[state_quant]} launch failed: "
                           f"cudaError {rc}")
    launches[state_quant] += t
    return y


def lstm_layer_fused(x_proj: torch.Tensor, w_hh: torch.Tensor,
                     h0: torch.Tensor | None = None,
                     c0: torch.Tensor | None = None,
                     state_quant: str = "none") -> torch.Tensor:
    """Run one LSTM layer: x_proj (B, T, 4H) = x @ W_ih + b, w_hh (H, 4H)
    in gate order [i, f, g, o] -> hidden states (B, T, H) float32.

    state_quant: "none" (fp32 h x bf16-rounded W_hh), "bf16" (h rounded to
    bf16 for the dot) or "int8" (W8A8 with h on the fixed scale 127, W_hh
    per-column int8). A CUDA ``x_proj`` launches the kernel (or raises);
    a CPU ``x_proj`` runs the plain version."""
    _check_args(x_proj, w_hh, h0, c0, state_quant)
    if x_proj.is_cuda:
        return _launch(x_proj, w_hh, h0, c0, state_quant)
    return lstm_layer_plain(x_proj, w_hh, h0, c0, state_quant)
