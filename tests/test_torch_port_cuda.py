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
from avvad_tpu_torch.utils import profiling

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


# (3, 7, 1030) and (40, 5, 1100) are outside the persistent plan (rows not
# 16-byte; a 137.5 KB weight slice beside the state of 5 tiles): the per-step
# kernels (int8 at 1030 with a zero-padded last word of k). (13, 7, 1000) has one
# batch tile a CTA, (64, 16, 1024) and (40, 9, 1024) pairs of tiles, the
# second with a tile alone at the end
@pytest.mark.parametrize("b, t, h", [(3, 7, 1024), (5, 4, 96), (64, 16, 1024), (3, 7, 1030),
                                     (13, 7, 1000), (40, 9, 1024), (40, 5, 1100)])
@pytest.mark.parametrize("state_quant", ["none", "bf16", "int8"])
def test_kernel_matches_plain(cuda, state_quant, b, t, h):
    """Each inference kernel against its plain version; the launch counts
    follow the route: one launch of ``lstm_f32h_persist``,
    ``lstm_bf16h_persist`` or ``lstm_int8_persist`` where the plan takes the
    layer, else T launches of the per-step kernel."""
    g = torch.Generator().manual_seed(0)
    xp = torch.randn(b, t, 4 * h, generator=g).to(cuda)
    w = (torch.randn(h, 4 * h, generator=g) / h ** 0.5).to(cuda)
    h0 = torch.tanh(torch.randn(b, h, generator=g)).to(cuda)
    c0 = torch.randn(b, h, generator=g).to(cuda)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variant = lstm_fused.infer_variant(state_quant, b, h, sms)
    profiling.reset()
    y = lstm_fused.lstm_layer_fused(xp, w, h0, c0, state_quant=state_quant)
    torch.cuda.synchronize()
    expect = dict.fromkeys(lstm_fused.KERNEL_NAMES, 0)
    persist = variant.endswith("_persist")
    expect[variant] = 1 if persist else t
    assert lstm_fused.launch_counts() == expect
    ref = lstm_fused.lstm_layer_plain(xp, w, h0, c0, state_quant=state_quant)
    assert y.shape == (b, t, h) and torch.isfinite(y).all()
    assert (y - ref).abs().max().item() < ATOL[state_quant]
    if variant == "int8_persist":  # exact int32 sums, the same float32 operations
        assert torch.equal(y, ref)
    if persist:  # partials summed in a fixed order
        assert torch.equal(lstm_fused.lstm_layer_fused(xp, w, h0, c0, state_quant=state_quant), y)


@pytest.mark.parametrize("b, t, h", [(64, 24, 1024), (3, 7, 1024), (13, 7, 1000), (40, 9, 1024),
                                     (200, 4, 1024)])
@pytest.mark.parametrize("state_quant", ["bf16", "int8"])
def test_quant_persistent_kernels_match_the_per_step_ones(cuda, state_quant, b, t, h):
    """``lstm_bf16h_persist`` / ``lstm_int8_persist`` against the per-step
    kernel of the same variant (the plan refused for it): int8 bit for bit,
    bf16 within the tensor cores' other fp32 summation order. (200, 4, 1024)
    walks 13 (bf16) or 7 (int8) batch tiles a CTA in four groups."""
    xp, w, h0, c0 = _train_inputs(b, t, h, cuda, seed=11)
    profiling.reset()
    y = lstm_fused.lstm_layer_fused(xp, w, h0, c0, state_quant=state_quant)
    plan, lstm_fused.persistent_plan = lstm_fused.persistent_plan, lambda *_a, **_k: None
    try:
        per_step = lstm_fused.lstm_layer_fused(xp, w, h0, c0, state_quant=state_quant)
    finally:
        lstm_fused.persistent_plan = plan
    torch.cuda.synchronize()
    counts = lstm_fused.launch_counts()
    assert counts[state_quant + "_persist"] == 1
    assert counts[state_quant] == t
    if state_quant == "int8":
        assert torch.equal(y, per_step)
    else:
        assert (y - per_step).abs().max().item() < ATOL["bf16"]


def test_quant_persistent_entries_refuse_a_shape_outside_the_plan(cuda):
    """The quantised C entries return a CUDA error, and launch nothing, for
    rows that are not 16-byte or a grid the card cannot hold at once."""
    from avvad_tpu_torch.ops._build import kernel_lib

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for b, t, h in ((2, 3, 1030), (2, 3, 16 * (sms + 1))):
        assert lstm_fused.persistent_plan(b, h, sms) is None
        xp, w, h0, c0 = _train_inputs(b, t, h, cuda)
        y = torch.empty(b, t, h, device=cuda)
        hx = torch.zeros(2, b, 2 * h + 32, dtype=torch.uint8, device=cuda)
        bar = lstm_fused._barrier(cuda, b)
        wq, ws = lstm_fused._quant_weights(w)
        rcs = (kernel_lib().lstm_bf16h_persist(
                   xp.data_ptr(), w.to(torch.bfloat16).data_ptr(), h0.data_ptr(),
                   c0.clone().data_ptr(), y.data_ptr(), hx.data_ptr(), bar.data_ptr(), b, t, h,
                   stream),
               kernel_lib().lstm_int8_persist(
                   xp.data_ptr(), wq.data_ptr(), ws.data_ptr(), h0.data_ptr(),
                   c0.clone().data_ptr(), y.data_ptr(), hx.data_ptr(), bar.data_ptr(), b, t, h,
                   stream))
        torch.cuda.synchronize()
        assert all(rc != 0 for rc in rcs) and not bar.any() and not hx.any()


def test_inference_route_on_this_card(cuda):
    """The serving shape goes through the persistent kernel on a card with
    64 or more SMs; with the plan refused the per-step kernel gives the same
    function."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (lstm_fused.infer_variant("none", 64, 1024, sms) == "none_persist") == (sms >= 64)
    xp, w, h0, c0 = _train_inputs(40, 6, 1024, cuda, seed=9)
    y = lstm_fused.lstm_layer_fused(xp, w, h0, c0)
    plan, lstm_fused.persistent_plan = lstm_fused.persistent_plan, lambda *_a, **_k: None
    try:
        profiling.reset()
        per_step = lstm_fused.lstm_layer_fused(xp, w, h0, c0)
        counts = lstm_fused.launch_counts()
        assert counts["none"] == 6 and not counts["none_persist"]
    finally:
        lstm_fused.persistent_plan = plan
    assert (y - per_step).abs().max().item() < ATOL["none"]


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
    before = profiling.launches().get(conv_fused.KERNEL_NAME, 0)
    y = _block(conv_fused.basic_block_int8, x, spec, stride)
    torch.cuda.synchronize()
    assert profiling.launches().get(conv_fused.KERNEL_NAME, 0) - before == 1
    ref = _block(conv_fused.basic_block_int8_plain, x, spec, stride)
    ho = conv_fused.conv_out(h, stride)
    assert y.shape == ref.shape == (37, ho, ho, cout)
    assert ref.float().std() > 10  # the test spreads over the int8 range
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


@pytest.mark.parametrize("n, h, w, stride, cin, cout, down", [
    (21, 7, 5, 2, 32, 96, True),     # n tiles of 32, odd H x W, stride 2
    (50, 6, 6, 1, 96, 96, False),    # identity at a width no trunk block has
    (9, 5, 4, 1, 64, 64, True),      # a 1x1 shortcut that keeps the shape
    (300, 3, 3, 1, 64, 192, True),   # n tiles of 64, several CTAs of several passes
    (2, 20, 12, 1, 32, 32, False)])  # few frames: a CTA a frame
def test_int8_basic_block_off_the_trunk(cuda, n, h, w, stride, cin, cout, down):
    """Shapes outside the trunk run the same kernel, bit-identical to the
    plain version, with the tiles packed by the wrapper."""
    spec = random_block(cin, cout, stride, n, cuda)
    if down and "wd" not in spec:
        extra = random_block(cin, 2 * cout, stride, n + 1, cuda)
        spec.update(wd=extra["wd"][:cout].contiguous(), ad=extra["ad"][:cout].contiguous(),
                    bd=extra["bd"][:cout].contiguous())
        del spec["res_scale"]
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-127, 128, (n, h, w, cin), generator=g, dtype=torch.int8).to(cuda)
    y = _block(conv_fused.basic_block_int8, x, spec, stride)
    torch.cuda.synchronize()
    ref = _block(conv_fused.basic_block_int8_plain, x, spec, stride)
    assert y.shape == ref.shape and ref.float().std() > 10
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    tiles = conv_fused.pack_block_tiles(spec["w1"], spec["w2"], spec.get("wd"))
    again = conv_fused.basic_block_int8(x, *conv_fused._block_args(spec), stride=stride,
                                        tiles=tiles)
    torch.testing.assert_close(again, ref, rtol=0, atol=0)


def test_int8_basic_block_refuses_what_the_plan_refuses(cuda):
    """A frame whose tiles exceed the shared memory raises with the plan's
    reason; tiles of another weight's shape raise too. Nothing is launched."""
    spec = random_block(64, 64, 1, 0, cuda)
    before = profiling.launches().get(conv_fused.KERNEL_NAME, 0)
    with pytest.raises(ValueError, match="shared memory"):
        _block(conv_fused.basic_block_int8,
               torch.zeros(1, 64, 64, 64, dtype=torch.int8, device=cuda), spec, 1)
    other = random_block(64, 128, 1, 1, cuda)
    with pytest.raises(ValueError, match="tiles"):
        conv_fused.basic_block_int8(
            torch.zeros(2, 5, 5, 64, dtype=torch.int8, device=cuda),
            *conv_fused._block_args(spec), stride=1,
            tiles=conv_fused.pack_block_tiles(other["w1"], other["w2"], other["wd"]))
    assert profiling.launches().get(conv_fused.KERNEL_NAME, 0) == before


def test_int8_trunk_kernels_match_plain(cuda):
    g = torch.Generator().manual_seed(7)
    x = torch.randint(0, 128, (19, 17, 17, 64), generator=g, dtype=torch.int8).to(cuda)
    specs, cin = [], 64
    for i, ((_, stride), cout) in enumerate(zip(conv_fused.TRUNK_GEOM,
                                                conv_fused.TRUNK_WIDTHS)):
        specs.append(random_block(cin, cout, stride, 20 + i, cuda))
        cin = cout
    specs[-1]["out_scale"] = torch.tensor(0.05, device=cuda)
    before = profiling.launches().get(conv_fused.KERNEL_NAME, 0)
    feats = conv_fused.trunk_features_int8(x, specs)
    torch.cuda.synchronize()
    assert profiling.launches().get(conv_fused.KERNEL_NAME, 0) - before == 8
    ref = x
    for spec, (_, stride) in zip(specs, conv_fused.TRUNK_GEOM):
        ref = _block(conv_fused.basic_block_int8_plain, ref, spec, stride)
    ref = ref.reshape(19, 9, 512).sum(1, dtype=torch.int32).float() * (0.05 / 9.0)
    assert feats.shape == (19, 512)
    torch.testing.assert_close(feats, ref, rtol=0, atol=0)


# the stem epilogue's route by the input's layout
STEM_KERNEL = {"nchw": stem_fused.KERNEL_NAME, "channels_last": stem_fused.NHWC_KERNEL_NAME}


@pytest.mark.parametrize("n", [37, 15744])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_epilogue_matches_plain(cuda, dtype, layout, n):
    """Each layout's kernel, at a ragged frame count and the serving step's
    (64 x 246 frames), bit for bit: a of both signs (the channels-last
    kernel pools before it quantises, on sign-flipped values)."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(n, 64, 34, 34, generator=g) * 3).to(cuda, dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    a = ((torch.rand(64, generator=g) * 20 + 5) * (torch.rand(64, generator=g) - 0.3).sign()).to(cuda)
    b = (torch.randn(64, generator=g) * 10 + 20).to(cuda)
    profiling.reset()
    y = stem_fused.stem_epilogue_pool_quant(x, a, b)
    torch.cuda.synchronize()
    assert profiling.counters("launch.stem") == {"launch." + STEM_KERNEL[layout]: 1}
    ref = stem_fused.stem_epilogue_plain(x, a, b)
    assert y.shape == (n, 17, 17, 64) and y.dtype == torch.int8
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


# (N, C, dtype): one frame; C = 16; channels over the 256 bytes of a unit
# (fp32 C = 160: slices of 32 channels, a bulk copy a pixel; bf16 C = 144:
# slices of 48)
@pytest.mark.parametrize("n, c, dtype", [(1, 64, torch.bfloat16), (5, 16, torch.bfloat16),
                                         (3, 16, torch.float32), (7, 160, torch.float32),
                                         (4, 144, torch.bfloat16), (400, 64, torch.float32)])
def test_stem_epilogue_nhwc_shapes(cuda, n, c, dtype):
    """The channels-last kernel off the serving shape, with the largest and
    smallest values of each channel at the frame's edges."""
    g = torch.Generator().manual_seed(n + c)
    x = torch.randn(n, 34, 34, c, generator=g) * 3
    x[:, 0, ::5] = 11.0
    x[:, 33, 1::7] = -11.0
    x[:, ::3, 33] = 10.0
    x[:, 2::9, 0] = -10.0
    x = x.permute(0, 3, 1, 2).to(cuda, dtype)
    a = ((torch.rand(c, generator=g) * 10 + 2) * (torch.rand(c, generator=g) - 0.4).sign()).to(cuda)
    b = (torch.randn(c, generator=g) * 20 + 40).to(cuda)
    profiling.reset()
    y = stem_fused.stem_epilogue_pool_quant(x, a, b)
    torch.cuda.synchronize()
    assert profiling.launches()[stem_fused.NHWC_KERNEL_NAME] == 1
    torch.testing.assert_close(y, stem_fused.stem_epilogue_plain(x, a, b), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "layout", "channels", "alignment"])
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
    elif bad == "channels":
        spec, x = random_block(48, 48, 1, 0, cuda), x[..., :48].contiguous()
        stem, a, b = stem[:, :40].contiguous(), a[:40], b[:40]
    else:  # channels-last input 4 bytes off a 16-byte boundary
        flat = torch.zeros(2 * 34 * 34 * 64 + 1, device=cuda)
        stem = flat[1:].view(2, 34, 34, 64).permute(0, 3, 1, 2)
        x = x.transpose(1, 2)
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
        profiling.reset()
        probs[dev] = fn(wave, video).cpu()
        expect = 8 if dev == "cuda" else 0
        assert profiling.launches().get(conv_fused.KERNEL_NAME, 0) == expect
        # the stem conv writes channels-last: the channels-last epilogue
        assert profiling.counters("launch.stem") == (
            {"launch." + stem_fused.NHWC_KERNEL_NAME: 1} if expect else {})
    torch.testing.assert_close(probs["cuda"], probs["cpu"], atol=1e-4, rtol=0)


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _train_inputs(b, t, h, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, t, 4 * h, generator=g).to(device),
            (torch.randn(h, 4 * h, generator=g) / h ** 0.5).to(device),
            torch.tanh(torch.randn(b, h, generator=g)).to(device),
            torch.randn(b, h, generator=g).to(device))


def _train_launches(b, t, h, calls=1):
    """The launch counts of ``calls`` K1d and K1e calls on this card: one
    launch a call where the persistent plan takes the shape, T and T + 1
    per-step launches where it does not."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if lstm_fused.persistent_plan(b, h, sms) is not None:
        return {"fwd_train_persist": calls, "bwd_persist": calls, "fwd_train": 0, "bwd": 0}
    return {"fwd_train_persist": 0, "bwd_persist": 0, "fwd_train": calls * t,
            "bwd": calls * (t + 1)}


def _train_counts():
    counts = lstm_fused.launch_counts()
    return {k: counts[k] for k in lstm_fused.TRAIN_KERNELS}


# (3, 7, 1030), (2, 3, 1120) and (4, 2, 2048) lie outside the persistent
# plan (rows not 16-byte; weight slices beyond the shared memory); (40, 9,
# 1024) is five batch tiles, the last ragged, on two row slices; (50, 5, 128)
# seven tiles with a row slice each; H = 100 is no multiple of the 16 units a
# CTA owns
@pytest.mark.parametrize("b, t, h", [(3, 7, 1024), (5, 4, 96), (16, 64, 1024), (3, 6, 100),
                                     (40, 9, 1024), (50, 5, 128), (3, 7, 1030),
                                     (2, 3, 1120), (4, 2, 2048)])
def test_train_kernels_match_plain(cuda, b, t, h):
    """K1d (y, c_seq, gates) and K1e (d_gates, dh0, dc0) against their plain
    versions on the same inputs, with the launch counts of the route the
    shape takes."""
    xp, w, h0, c0 = _train_inputs(b, t, h, cuda)
    c0_before = c0.clone()
    profiling.reset()
    got = lstm_fused.lstm_fwd_train(xp, w, h0, c0)
    torch.cuda.synchronize()
    expect = _train_launches(b, t, h)
    assert _train_counts() == {**expect, "bwd_persist": 0, "bwd": 0}
    assert torch.equal(c0, c0_before)  # the kernel advances a copy
    ref = lstm_fused.lstm_fwd_train_plain(xp, w, h0, c0)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and (a - r).abs().max().item() < ATOL["none"]
    _, c_seq, gates = ref
    dy = torch.randn(b, t, h, generator=torch.Generator().manual_seed(1)).to(cuda)
    c_prev = torch.cat([c0[:, None], c_seq[:, :-1]], dim=1)
    got = lstm_fused.lstm_bwd(dy, gates, c_seq, c_prev, w)
    torch.cuda.synchronize()
    assert _train_counts() == expect
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

    profiling.reset()
    got = grads()
    assert _train_counts() == _train_launches(4, 33, 256)
    monkeypatch.setattr(lstm_fused, "lstm_fwd_train", lstm_fused.lstm_fwd_train_plain)
    monkeypatch.setattr(lstm_fused, "lstm_bwd", lstm_fused.lstm_bwd_plain)
    for a, ref in zip(got, grads()):
        assert a.dtype == torch.float32 and _rel(a, ref) < 1e-4


def test_persistent_kernels_repeat_bit_for_bit(cuda):
    """The partials are summed in a fixed order: two launches agree exactly."""
    xp, w, h0, c0 = _train_inputs(16, 24, 1024, cuda, seed=5)
    dy = torch.randn(16, 24, 1024, generator=torch.Generator().manual_seed(6)).to(cuda)
    runs = []
    for _ in range(2):
        y, c_seq, gates = lstm_fused.lstm_fwd_train(xp, w, h0, c0)
        c_prev = torch.cat([c0[:, None], c_seq[:, :-1]], dim=1)
        runs.append((y, c_seq, gates, *lstm_fused.lstm_bwd(dy, gates, c_seq, c_prev, w)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_persistent_entry_refuses_a_shape_outside_the_plan(cuda):
    """The C entries return a CUDA error, and launch nothing, for a grid the
    card cannot hold at once, a weight slice beyond the shared memory or rows
    that are not 16-byte: the wrapper's rule, not a failed launch, picks the
    per-step route."""
    from avvad_tpu_torch.ops._build import kernel_lib

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, t, h in ((2, 3, 16 * (sms + 1)), (2, 3, 1120), (2, 3, 1030)):
        assert lstm_fused.persistent_plan(b, h, sms) is None
        xp, w, h0, c0 = _train_inputs(b, t, h, cuda)
        y, c_seq = torch.empty(b, t, h, device=cuda), torch.empty(b, t, h, device=cuda)
        gates = torch.empty(b, t, 4 * h, device=cuda)
        bar = lstm_fused._barrier(cuda, b)
        rc = kernel_lib().lstm_fwd_train_persist(
            xp.data_ptr(), w.to(torch.bfloat16).data_ptr(), h0.data_ptr(),
            c0.clone().data_ptr(), y.data_ptr(), c_seq.data_ptr(), gates.data_ptr(),
            bar.data_ptr(), b, t, h, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc != 0 and not bar.any()


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
        profiling.reset()
        state, metrics = make_train_step("av")(state, batch)
        torch.cuda.synchronize()
        # two layers: two K1d and two K1e calls
        expect = (dict.fromkeys(lstm_fused.TRAIN_KERNELS, 0) if plain
                  else _train_launches(2, 16, 64, calls=2))
        assert _train_counts() == expect
        assert lstm_fused.launch_counts()["none"] == 0
        results.append((metrics, {n: p.grad for n, p in state.model.named_parameters()
                                  if p.grad is not None}))
    (m_k, g_k), (m_p, g_p) = results
    assert g_k.keys() == g_p.keys() and len(g_k) == 10
    torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=1e-5, atol=0)
    for n in g_k:
        assert _rel(g_k[n], g_p[n]) < 1e-4, n


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_video_train_step_kernels_match_plain(cuda, monkeypatch, remat):
    """One VideoVAD train step (its ResNet-18 trained, 2 x LSTM 64, B=2,
    T=16) with the training kernels against the same step with their plain
    versions, cuDNN deterministic: loss, and every gradient, the trunk's 60
    included, at the training path's 1e-3 (chip_smoke.py)."""
    import copy

    from avvad_tpu_torch.data import Batch
    from avvad_tpu_torch.models import VideoVAD
    from avvad_tpu_torch.train import create_train_state, make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rng = np.random.default_rng(1)
    lengths = np.array([16, 11])
    mask = (np.arange(16)[None] < lengths[:, None]).astype(np.float32)
    batch = Batch(audio=None,
                  video=rng.normal(size=(2, 16, 67, 67)).astype(np.float32),
                  label=(rng.random((2, 16, 1)) > 0.5).astype(np.float32),
                  lengths=lengths, mask=mask)
    model = VideoVAD(lstm_hidden_size=64, lstm_layers=2, use_kernel_lstm=True, remat=remat)
    results = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(lstm_fused, "lstm_fwd_train", lstm_fused.lstm_fwd_train_plain)
            monkeypatch.setattr(lstm_fused, "lstm_bwd", lstm_fused.lstm_bwd_plain)
        state = create_train_state(copy.deepcopy(model), device=cuda)
        profiling.reset()
        state, metrics = make_train_step("video")(state, batch)
        torch.cuda.synchronize()
        expect = (dict.fromkeys(lstm_fused.TRAIN_KERNELS, 0) if plain
                  else _train_launches(2, 16, 64, calls=2))
        assert _train_counts() == expect
        results.append((metrics, {n: p.grad for n, p in state.model.named_parameters()}))
    (m_k, g_k), (m_p, g_p) = results
    assert g_k.keys() == g_p.keys()
    assert sum(n.startswith("tower.features.") for n in g_k) == 60
    torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=1e-5, atol=0)
    for n in g_k:
        assert _rel(g_k[n], g_p[n]) < 1e-3, n


def test_int8_video_ticks_match_plain(cuda, monkeypatch):
    """MultiStreamVideoVAD with the static-int8 tower on the card, 30 fps
    uint8 camera frames, 2 streams: each tick launches the channels-last K3
    once and K2 eight times, and the ticks equal (1e-4) the same ticks with
    the plain K2 / K3 on the card."""
    import avvad_tpu_torch.models.resnet as resnet_mod
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.models import VideoVAD, calibrate

    rng = np.random.default_rng(2)
    vid = [np.round(rng.random((24, 67, 67)) * 255).astype(np.float32) for _ in range(2)]
    model = VideoVAD(lstm_hidden_size=64, lstm_layers=2, tower_int8=True,
                     tower_quant_mode="static", tower_pallas=True)
    calibrate(model, [torch.from_numpy(np.stack(vid))])

    def ticks(count):
        ms = serve.MultiStreamVideoVAD(model, 2, block_frames=16, video_fps=30.0,
                                       video_uint8=True, device=cuda)
        for i in range(2):
            ms.feed(i, video_frames=vid[i])
        out = []
        for _ in range(2):
            profiling.reset()
            got = ms.tick()
            assert set(got) == {0, 1}
            if count:
                assert profiling.launches().get(conv_fused.KERNEL_NAME, 0) == 8
                assert profiling.counters("launch.stem") == {
                    "launch." + stem_fused.NHWC_KERNEL_NAME: 1}
            out.append(np.stack([got[0], got[1]]))
        return np.concatenate(out, axis=1)

    kernels = ticks(True)
    monkeypatch.setattr(resnet_mod, "stem_epilogue_pool_quant", stem_fused.stem_epilogue_plain)
    monkeypatch.setattr(conv_fused, "basic_block_int8", conv_fused.basic_block_int8_plain)
    plain = ticks(False)
    assert kernels.shape == (2, 32)
    np.testing.assert_allclose(kernels, plain, atol=1e-4)


# the probe kernel against its plain version: "full" and "matmul_only" are
# fp32 in another summation order, "gates_only" differs by expf/tanhf only,
# "h_bf16" adds the rare h that crosses a bf16 rounding boundary
PROBE_ATOL = {"full": 1e-4, "gates_only": 1e-4, "matmul_only": 1e-4, "h_bf16": 2e-3}


# inside the persistent plan: one tile a CTA (3, 7, 1024), (13, 7, 1000);
# pairs of tiles (64, 16, 1024); outside it (3, 7, 1030) and (5, 4, 1022):
# the per-step probe
@pytest.mark.parametrize("b, t, h", [(3, 7, 1024), (5, 4, 96), (64, 16, 1024), (13, 7, 1000),
                                     (3, 7, 1030), (5, 4, 1022)])
@pytest.mark.parametrize("mode", lstm_fused.PROBE_MODES)
def test_probe_kernel_matches_plain(cuda, mode, b, t, h):
    """The probe's own draws (x_proj x 0.1, W x 0.02: "matmul_only" is a
    linear recurrence that a wider W lets diverge), non-zero h0 and c0; the
    launch counters show the route of ``probe_variant``."""
    rng = np.random.default_rng(0)
    xp = torch.from_numpy(rng.normal(size=(b, t, 4 * h)).astype(np.float32) * 0.1).to(cuda)
    w = torch.from_numpy(rng.normal(size=(h, 4 * h)).astype(np.float32) * 0.02).to(cuda)
    h0 = torch.from_numpy(np.tanh(rng.normal(size=(b, h))).astype(np.float32)).to(cuda)
    c0 = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda)
    c0_before = c0.clone()
    profiling.reset()
    y = lstm_fused.lstm_probe(xp, w, h0, c0, mode)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    route = lstm_fused.probe_variant(mode, b, h, sms)
    assert route == ("probe" if h in (1030, 1022) else "probe_persist")
    # counted under the probe's route only
    assert lstm_fused.launch_counts() == {**dict.fromkeys(lstm_fused.KERNEL_NAMES, 0),
                                          route: t if route == "probe" else 1}
    assert torch.equal(c0, c0_before)  # the kernel advances a copy
    ref = lstm_fused.lstm_probe_plain(xp, w, h0, c0, mode)
    assert y.shape == (b, t, h) and torch.isfinite(y).all()
    assert (y - ref).abs().max().item() < PROBE_ATOL[mode]
    if mode == "gates_only":  # W is never read
        y2 = lstm_fused.lstm_probe(xp, torch.full_like(w, float("nan")), h0, c0, mode)
        assert torch.equal(y, y2)


@pytest.mark.parametrize("b, t, h", [(64, 16, 1024), (3, 7, 1024), (13, 7, 1000)])
def test_persistent_probe_equals_the_serving_kernels(cuda, b, t, h):
    """P1 "full" and "h_bf16" on the persistent frame are the kernels that
    serving runs at the shape, bit for bit."""
    rng = np.random.default_rng(1)
    xp = torch.from_numpy(rng.normal(size=(b, t, 4 * h)).astype(np.float32) * 0.1).to(cuda)
    w = torch.from_numpy(rng.normal(size=(h, 4 * h)).astype(np.float32) * 0.02).to(cuda)
    h0 = torch.from_numpy(np.tanh(rng.normal(size=(b, h))).astype(np.float32)).to(cuda)
    c0 = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda)
    for mode, sq in (("full", "none"), ("h_bf16", "bf16")):
        profiling.reset()
        got = lstm_fused.lstm_probe(xp, w, h0, c0, mode)
        want = lstm_fused.lstm_layer_fused(xp, w, h0, c0, sq)
        torch.cuda.synchronize()
        counts = lstm_fused.launch_counts()
        assert counts["probe_persist"] == 1
        assert counts[sq + "_persist"] == 1
        assert torch.equal(got, want), mode


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


def test_exported_int8_step_replays_the_kernels(cuda, tmp_path):
    """A serving artifact of the int8-tower AV step exported on the card:
    the program calls the three custom ops, its replay launches K1b twice,
    K3 once and K2 eight times (the counters read around the replay
    alone), and equals the live step bit for bit."""
    from avvad_tpu_torch.export import ServingArtifact, make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD, calibrate

    t = 8
    model = AVVAD(lstm_hidden_size=64, lstm_layers=2, mcb_output_size=256,
                  use_kernel_lstm=True, lstm_state_quant="int8", tower_int8=True,
                  tower_quant_mode="static", tower_pallas=True).to(cuda)
    g = torch.Generator().manual_seed(0)
    wave = torch.randn(2, 256 * (t - 1) + 1024, generator=g).to(cuda)
    video = (torch.rand(2, t, 67, 67, generator=g) * 255).to(cuda)
    calibrate(model, [(torch.zeros(2, t, 513, device=cuda), video)])
    fn = make_waveform_serving_fn(model, t_frames=t, device=cuda)
    live = fn(wave, video)
    path = str(tmp_path / "int8.avvadx")
    ServingArtifact.build({"b2": (fn, (wave, video))}).save(path)
    loaded = ServingArtifact.load(path)
    assert len(loaded.meta["custom_ops"]["b2"]) == 3 and loaded.meta["device"] == "cuda"
    profiling.reset()
    got = loaded.call("b2", wave, video)
    torch.cuda.synchronize()
    assert profiling.launches().get(conv_fused.KERNEL_NAME, 0) == 8
    assert profiling.counters("launch.stem") == {"launch." + stem_fused.NHWC_KERNEL_NAME: 1}
    assert sum(lstm_fused.launch_counts().values()) == 2
    assert torch.equal(got, live)
