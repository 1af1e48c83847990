"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips inside its fixture when no CUDA device is
visible (never at import), so all pytest-xdist workers collect the same
tests. Run on a machine with the card:
``python -m pytest -m cuda tests/test_torch_port_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from avvad_tpu_torch.ops import conv_fused, lstm_fused, stem_fused

pytestmark = pytest.mark.cuda

# kernel vs plain on the same card: identical fp32 formulas in another
# summation order (and expf/tanhf vs PyTorch's), compounded over T steps;
# for bf16 / int8 also the rare h whose fp32 noise crosses a rounding
# boundary of the quantised state (one LSB of one gate term)
ATOL = {"none": 1e-4, "bf16": 2e-3, "int8": 2e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b, t, h", [(3, 7, 1024), (5, 4, 96), (64, 16, 1024)])
@pytest.mark.parametrize("state_quant", ["none", "bf16", "int8"])
def test_kernel_matches_plain(cuda, state_quant, b, t, h):
    g = torch.Generator().manual_seed(0)
    xp = torch.randn(b, t, 4 * h, generator=g).to(cuda)
    w = (torch.randn(h, 4 * h, generator=g) / h ** 0.5).to(cuda)
    h0 = torch.tanh(torch.randn(b, h, generator=g)).to(cuda)
    c0 = torch.randn(b, h, generator=g).to(cuda)
    before = lstm_fused.launches[state_quant]
    y = lstm_fused.lstm_layer_fused(xp, w, h0, c0, state_quant=state_quant)
    torch.cuda.synchronize()
    assert lstm_fused.launches[state_quant] - before == t
    ref = lstm_fused.lstm_layer_plain(xp, w, h0, c0, state_quant=state_quant)
    assert y.shape == (b, t, h) and torch.isfinite(y).all()
    assert (y - ref).abs().max().item() < ATOL[state_quant]


@pytest.mark.parametrize("state_quant", ["none", "int8"])
def test_kernel_on_explicit_device_index(cuda, state_quant):
    """Tensors on the last visible card, with card 0 current: the wrapper
    makes the tensors' card current for the launch (on a one-card machine
    both are card 0)."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    g = torch.Generator().manual_seed(3)
    xp = torch.randn(4, 5, 4 * 64, generator=g).to(dev)
    w = (torch.randn(64, 4 * 64, generator=g) / 8).to(dev)
    with torch.cuda.device(0):
        y = lstm_fused.lstm_layer_fused(xp, w, state_quant=state_quant)
    torch.cuda.synchronize(dev)
    assert y.device == dev
    ref = lstm_fused.lstm_layer_plain(xp, w, state_quant=state_quant)
    assert (y - ref).abs().max().item() < ATOL[state_quant]


def test_kernel_raises_on_wrong_dtype(cuda):
    xp = torch.zeros(2, 3, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        lstm_fused.lstm_layer_fused(xp, torch.zeros(8, 32, device=cuda))


def test_serving_fn_on_card_matches_cpu(cuda):
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD

    rng = np.random.default_rng(0)
    wave = rng.normal(size=(2, 256 * 15 + 1024)).astype(np.float32)
    video = rng.normal(size=(2, 8, 67, 67)).astype(np.float32)
    idx = np.repeat(np.arange(8), 2)
    probs = {}
    for dev in ("cpu", "cuda"):
        model = AVVAD(lstm_hidden_size=64, lstm_layers=2, use_kernel_lstm=True)
        fn = make_waveform_serving_fn(model, t_frames=16,
                                      video_frame_indices=idx, device=dev)
        probs[dev] = fn(wave, video).cpu()
    # fp32 throughout on both; cuDNN and CPU convs and DFTs reassociate
    torch.testing.assert_close(probs["cuda"], probs["cpu"], atol=1e-4, rtol=0)


def random_block(cin, cout, stride, seed, device):
    """Seeded int8 weights and folded epilogue vectors for one fused block,
    scaled so that the requantised values spread over [0, 127]."""
    g = torch.Generator().manual_seed(seed)
    w = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8)  # noqa: E731
    vec = lambda lo, hi: torch.rand(cout, generator=g) * (hi - lo) + lo  # noqa: E731
    args = {"w1": w(cout, 9 * cin), "w2": w(cout, 9 * cout),
            "a1": vec(0.5, 1.5) * 64 / (73 * 73 * (9 * cin) ** 0.5),
            "b1": vec(-20, 20),
            "a2": vec(0.5, 1.5) * 64 / (73 * 40 * (9 * cout) ** 0.5),
            "b2": vec(-20, 20)}
    if stride != 1 or cin != cout:
        args.update(wd=w(cout, cin), ad=vec(0.5, 1.5) * 64 / (73 * 73 * cin ** 0.5),
                    bd=vec(-20, 20))
    else:
        args["res_scale"] = torch.tensor(0.37)
    return {k: v.to(device) for k, v in args.items()}


def _block(fn, x, spec, stride):
    return fn(x, *conv_fused._block_args(spec), stride=stride)


@pytest.mark.parametrize("geom", range(8))
def test_int8_basic_block_matches_plain(cuda, geom):
    """Each trunk geometry at a ragged N (37 frames: not a multiple of any
    frames-per-CTA choice): the kernel is bit-identical to its plain
    version (int32 sums exact, the same float32 operations)."""
    h, stride = conv_fused.TRUNK_GEOM[geom]
    cin = 64 if geom < 3 else conv_fused.TRUNK_WIDTHS[geom - 1]
    cout = conv_fused.TRUNK_WIDTHS[geom]
    spec = random_block(cin, cout, stride, geom, cuda)
    g = torch.Generator().manual_seed(100 + geom)
    x = torch.randint(-127, 128, (37, h, h, cin), generator=g, dtype=torch.int8).to(cuda)
    before = conv_fused.launches["int8_basic_block"]
    y = _block(conv_fused.basic_block_int8, x, spec, stride)
    torch.cuda.synchronize()
    assert conv_fused.launches["int8_basic_block"] - before == 1
    ref = _block(conv_fused.basic_block_int8_plain, x, spec, stride)
    ho = conv_fused.conv_out(h, stride)
    assert y.shape == ref.shape == (37, ho, ho, cout)
    assert ref.float().std() > 10  # the test spreads over the int8 range
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


def test_int8_trunk_kernels_match_plain(cuda):
    g = torch.Generator().manual_seed(7)
    x = torch.randint(0, 128, (19, 17, 17, 64), generator=g, dtype=torch.int8).to(cuda)
    specs, cin = [], 64
    for i, ((_, stride), cout) in enumerate(zip(conv_fused.TRUNK_GEOM,
                                                conv_fused.TRUNK_WIDTHS)):
        specs.append(random_block(cin, cout, stride, 20 + i, cuda))
        cin = cout
    specs[-1]["out_scale"] = torch.tensor(0.05, device=cuda)
    before = conv_fused.launches["int8_basic_block"]
    feats = conv_fused.trunk_features_int8(x, specs)
    torch.cuda.synchronize()
    assert conv_fused.launches["int8_basic_block"] - before == 8
    ref = x
    for spec, (_, stride) in zip(specs, conv_fused.TRUNK_GEOM):
        ref = _block(conv_fused.basic_block_int8_plain, ref, spec, stride)
    ref = ref.reshape(19, 9, 512).sum(1, dtype=torch.int32).float() * (0.05 / 9.0)
    assert feats.shape == (19, 512)
    torch.testing.assert_close(feats, ref, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_epilogue_matches_plain(cuda, dtype, layout):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(37, 64, 34, 34, generator=g) * 3).to(cuda, dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    a = (torch.rand(64, generator=g) * 20 + 5).to(cuda)
    b = (torch.randn(64, generator=g) * 10).to(cuda)
    before = stem_fused.launches["stem_epilogue_pool"]
    y = stem_fused.stem_epilogue_pool_quant(x, a, b)
    torch.cuda.synchronize()
    assert stem_fused.launches["stem_epilogue_pool"] - before == 1
    ref = stem_fused.stem_epilogue_plain(x, a, b)
    assert y.shape == (37, 17, 17, 64) and y.dtype == torch.int8
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "layout", "channels"])
def test_int8_kernel_wrappers_raise(cuda, bad):
    spec = random_block(64, 64, 1, 0, cuda)
    x = torch.zeros(2, 17, 17, 64, dtype=torch.int8, device=cuda)
    stem = torch.zeros(2, 64, 34, 34, device=cuda)
    a = b = torch.ones(64, device=cuda)
    if bad == "dtype":
        x, stem = x.float(), stem.half()
    elif bad == "layout":
        x = x.transpose(1, 2)
        stem = stem.transpose(2, 3)
    else:
        spec, x = random_block(48, 48, 1, 0, cuda), x[..., :48].contiguous()
        stem, a, b = stem[:, :40].contiguous(), a[:40], b[:40]
    with pytest.raises(ValueError):
        _block(conv_fused.basic_block_int8, x, spec, 1)
    with pytest.raises(ValueError):
        stem_fused.stem_epilogue_pool_quant(stem, a, b)


def test_int8_serving_fn_on_card_matches_cpu(cuda):
    """The static-int8 AV step (fused tower, kernel LSTM) calibrated once on
    the CPU, then served on the CPU (plain versions) and on the card
    (kernels): the stem conv's float32 reassociation can flip a rounding
    tie by one LSB, which the MCB normalisation damps."""
    import copy

    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD, calibrate

    rng = np.random.default_rng(0)
    wave = rng.normal(size=(2, 256 * 15 + 1024)).astype(np.float32)
    video = rng.normal(size=(2, 8, 67, 67)).astype(np.float32)
    idx = np.repeat(np.arange(8), 2)
    model = AVVAD(lstm_hidden_size=64, lstm_layers=2, use_kernel_lstm=True,
                  tower_int8=True, tower_quant_mode="static", tower_pallas=True)
    calibrate(model, [(torch.zeros(2, 16, 513), torch.from_numpy(video))],
              video_frame_indices=torch.from_numpy(idx))
    probs = {}
    for dev in ("cpu", "cuda"):
        fn = make_waveform_serving_fn(copy.deepcopy(model), t_frames=16,
                                      video_frame_indices=idx, device=dev)
        conv_fused.reset_launches()
        stem_fused.reset_launches()
        probs[dev] = fn(wave, video).cpu()
        expect = 8 if dev == "cuda" else 0
        assert conv_fused.launches["int8_basic_block"] == expect
        assert stem_fused.launches["stem_epilogue_pool"] == expect // 8
    torch.testing.assert_close(probs["cuda"], probs["cpu"], atol=1e-4, rtol=0)


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _train_inputs(b, t, h, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, t, 4 * h, generator=g).to(device),
            (torch.randn(h, 4 * h, generator=g) / h ** 0.5).to(device),
            torch.tanh(torch.randn(b, h, generator=g)).to(device),
            torch.randn(b, h, generator=g).to(device))


@pytest.mark.parametrize("b, t, h", [(3, 7, 1024), (5, 4, 96), (16, 64, 1024)])
def test_train_kernels_match_plain(cuda, b, t, h):
    """K1d (y, c_seq, gates) and K1e (d_gates, dh0, dc0) against their plain
    versions on the same inputs, with launch counts (T and T + 1)."""
    xp, w, h0, c0 = _train_inputs(b, t, h, cuda)
    lstm_fused.reset_launches()
    got = lstm_fused.lstm_fwd_train(xp, w, h0, c0)
    torch.cuda.synchronize()
    assert lstm_fused.launches["fwd_train"] == t
    ref = lstm_fused.lstm_fwd_train_plain(xp, w, h0, c0)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and (a - r).abs().max().item() < ATOL["none"]
    _, c_seq, gates = ref
    dy = torch.randn(b, t, h, generator=torch.Generator().manual_seed(1)).to(cuda)
    c_prev = torch.cat([c0[:, None], c_seq[:, :-1]], dim=1)
    got = lstm_fused.lstm_bwd(dy, gates, c_seq, c_prev, w)
    torch.cuda.synchronize()
    assert lstm_fused.launches["bwd"] == t + 1
    ref = lstm_fused.lstm_bwd_plain(dy, gates, c_seq, c_prev, w)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and torch.isfinite(a).all() and _rel(a, r) < 1e-4


def test_recurrence_function_grads_match_plain(cuda, monkeypatch):
    """The Function's four gradients with the kernels against the same
    Function with the two plain versions, on the card."""
    xp, w, h0, c0 = _train_inputs(4, 33, 256, cuda, seed=2)
    r = torch.randn(4, 33, 256, generator=torch.Generator().manual_seed(3)).to(cuda)

    def grads():
        args = [a.clone().requires_grad_() for a in (xp, w, h0, c0)]
        (lstm_fused.LSTMRecurrence.apply(*args) * r).sum().backward()
        return [a.grad for a in args]

    lstm_fused.reset_launches()
    got = grads()
    assert lstm_fused.launches["fwd_train"] == 33 and lstm_fused.launches["bwd"] == 34
    monkeypatch.setattr(lstm_fused, "lstm_fwd_train", lstm_fused.lstm_fwd_train_plain)
    monkeypatch.setattr(lstm_fused, "lstm_bwd", lstm_fused.lstm_bwd_plain)
    for a, ref in zip(got, grads()):
        assert a.dtype == torch.float32 and _rel(a, ref) < 1e-4


def test_lstm_layer_fused_keeps_the_graph_on_cuda(cuda):
    """Under autograd the CUDA path returns a tensor with a grad_fn, and
    W_hh, x_proj, h0 and c0 receive gradients (the inference kernel's
    output has none)."""
    xp, w, h0, c0 = (a.requires_grad_() for a in _train_inputs(2, 5, 64, cuda))
    y = lstm_fused.lstm_layer_fused(xp, w, h0, c0)
    assert y.grad_fn is not None
    y.sum().backward()
    assert all(a.grad is not None and a.grad.abs().sum() > 0 for a in (xp, w, h0, c0))
    with torch.no_grad():
        assert lstm_fused.lstm_layer_fused(xp, w).grad_fn is None


def test_av_train_step_kernels_match_plain(cuda, monkeypatch):
    """One AV train step (frozen trunk, MCB 128, 2 x LSTM 64, B=2, T=16)
    with the training kernels against the same step with their plain
    versions: loss and every trainable gradient."""
    import copy

    from avvad_tpu_torch.data import Batch
    from avvad_tpu_torch.models import AVVAD
    from avvad_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(0)
    lengths = np.array([16, 9])
    mask = (np.arange(16)[None] < lengths[:, None]).astype(np.float32)
    batch = Batch(audio=rng.normal(size=(2, 16, 513)).astype(np.float32),
                  video=rng.normal(size=(2, 16, 67, 67)).astype(np.float32),
                  label=(rng.random((2, 16, 1)) > 0.5).astype(np.float32),
                  lengths=lengths, mask=mask)
    model = AVVAD(lstm_hidden_size=64, lstm_layers=2, mcb_output_size=128,
                  use_kernel_lstm=True)
    results = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(lstm_fused, "lstm_fwd_train", lstm_fused.lstm_fwd_train_plain)
            monkeypatch.setattr(lstm_fused, "lstm_bwd", lstm_fused.lstm_bwd_plain)
        state = create_train_state(copy.deepcopy(model), freeze_video_trunk=True,
                                   device=cuda)
        lstm_fused.reset_launches()
        state, metrics = make_train_step("av")(state, batch)
        torch.cuda.synchronize()
        expect = {"fwd_train": 0, "bwd": 0} if plain else {"fwd_train": 32, "bwd": 34}
        assert {k: lstm_fused.launches[k] for k in expect} == expect
        assert lstm_fused.launches["none"] == 0
        results.append((metrics, {n: p.grad for n, p in state.model.named_parameters()
                                  if p.grad is not None}))
    (m_k, g_k), (m_p, g_p) = results
    assert g_k.keys() == g_p.keys() and len(g_k) == 10
    torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=1e-5, atol=0)
    for n in g_k:
        assert _rel(g_k[n], g_p[n]) < 1e-4, n


# the probe kernel against its plain version: "full" and "matmul_only" are
# fp32 in another summation order, "gates_only" differs by expf/tanhf only,
# "h_bf16" adds the rare h that crosses a bf16 rounding boundary
PROBE_ATOL = {"full": 1e-4, "gates_only": 1e-4, "matmul_only": 1e-4, "h_bf16": 2e-3}


@pytest.mark.parametrize("b, t, h", [(3, 7, 1024), (5, 4, 96), (64, 16, 1024)])
@pytest.mark.parametrize("mode", lstm_fused.PROBE_MODES)
def test_probe_kernel_matches_plain(cuda, mode, b, t, h):
    """The probe's own draws (x_proj x 0.1, W x 0.02: "matmul_only" is a
    linear recurrence that a wider W lets diverge), non-zero h0 and c0."""
    rng = np.random.default_rng(0)
    xp = torch.from_numpy(rng.normal(size=(b, t, 4 * h)).astype(np.float32) * 0.1).to(cuda)
    w = torch.from_numpy(rng.normal(size=(h, 4 * h)).astype(np.float32) * 0.02).to(cuda)
    h0 = torch.from_numpy(np.tanh(rng.normal(size=(b, h))).astype(np.float32)).to(cuda)
    c0 = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda)
    c0_before = c0.clone()
    lstm_fused.reset_launches()
    y = lstm_fused.lstm_probe(xp, w, h0, c0, mode)
    torch.cuda.synchronize()
    assert lstm_fused.launches["probe"] == t
    assert sum(lstm_fused.launches.values()) == t  # counted under the probe only
    assert torch.equal(c0, c0_before)  # the kernel advances a copy
    ref = lstm_fused.lstm_probe_plain(xp, w, h0, c0, mode)
    assert y.shape == (b, t, h) and torch.isfinite(y).all()
    assert (y - ref).abs().max().item() < PROBE_ATOL[mode]
    if mode == "gates_only":  # W is never read
        y2 = lstm_fused.lstm_probe(xp, torch.full_like(w, float("nan")), h0, c0, mode)
        assert torch.equal(y, y2)


def test_probe_kernel_raises_on_wrong_device_or_dtype(cuda):
    xp = torch.zeros(2, 3, 32, device=cuda)
    with pytest.raises(ValueError):
        lstm_fused.lstm_probe(xp, torch.zeros(8, 32), mode="full")  # W on the CPU
    with pytest.raises(ValueError):
        lstm_fused.lstm_probe(xp.half(), torch.zeros(8, 32, device=cuda), mode="full")


@pytest.mark.parametrize("route", ["hop_dft", "split_radix"])
def test_dft_routes_match_direct_on_card(cuda, route):
    from avvad_tpu_torch.ops.stft import stft_frames

    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 256 * 63 + 1024))
                         .astype(np.float32) * 0.3).to(cuda)
    tol = {"hop_dft": 1e-5, "split_radix": 1e-4}[route]
    for got, want in zip(stft_frames(x, **{route: True}), stft_frames(x)):
        assert got.shape == want.shape == (4, 64, 513)
        assert ((got - want).abs().max() / want.abs().max()).item() < tol


@pytest.mark.parametrize("kind", ["audio", "av"])
def test_streaming_ticks_on_card_match_cpu(cuda, kind):
    """A multi-stream server on the card (pinned staging uploads, the
    pipelined tick with its side-stream download) against the same server
    on the CPU: fp32 on both; cuDNN and CPU convs and DFTs reassociate."""
    import copy

    from avvad_tpu_torch import serve
    from avvad_tpu_torch.models import AVVAD, AudioVAD

    rng = np.random.default_rng(0)
    pcm = [(rng.normal(size=1024 + 256 * 23) * 8000).astype(np.int16) for _ in range(2)]
    vid = [np.round(rng.random((12, 67, 67)) * 255).astype(np.float32) for _ in range(2)]
    model = (AVVAD(lstm_hidden_size=64, lstm_layers=2, mcb_output_size=128)
             if kind == "av" else AudioVAD(lstm_hidden_size=64, lstm_layers=2))
    outs = {}
    for dev in ("cpu", "cuda"):
        kw = dict(block_frames=8, span_wire=True, hop_dft=True, audio_int16=True,
                  device=dev)
        if kind == "av":
            ms = serve.MultiStreamAVVAD(copy.deepcopy(model), 2, video_fps=30.0,
                                        video_uint8=True, **kw)
            for i in range(2):
                ms.feed(i, pcm=pcm[i], video_frames=vid[i])
        else:
            ms = serve.MultiStreamVAD(copy.deepcopy(model), 2, **kw)
            for i in range(2):
                ms.feed(i, pcm[i])
        ms.warmup()
        ticks = [ms.tick_pipelined() for _ in range(3)] + [ms.flush_pipelined()]
        assert ticks[0] == {} and all(set(t) == {0, 1} for t in ticks[1:])
        outs[dev] = np.concatenate([np.stack([t[0], t[1]]) for t in ticks[1:]], axis=1)
    assert outs["cuda"].shape == (2, 24)
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=1e-4)
