"""The float trunk's train-mode BatchNorm kernels (``ops/bn_fused.py``,
``csrc/batch_norm.cu``): the plain twin against today's expressions, the
model's routing rule, and on the card the kernels against the plain version.

The CPU tests count the custom ops' CPU calls (their plain versions) with the
kernels' device types widened to the CPU. The card tests are marked ``cuda``
and skip inside their fixture without a CUDA device; run them on a machine
with the card: ``python -m pytest --noconftest -m cuda tests/test_torch_port_bn.py -q``.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avvad_tpu_torch.models import resnet
from avvad_tpu_torch.ops import bn_fused
from avvad_tpu_torch.utils import profiling

FORMS = ("relu", "identity", "downsample", "pool")


def _bn(c: int, seed: int) -> torch.nn.BatchNorm2d:
    """A train-mode BatchNorm with drawn parameters and running statistics,
    frozen."""
    g = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn.requires_grad_(False).train()


def _parent_batch_norm(bn, x):
    """``resnet.batch_norm`` in train mode (no data group) as it was written
    before the fused path: flax's statistics, the running statistics'
    update, (x - mean) * mul + bias."""
    axes = [0, 2, 3]
    mean = x.mean(axes)
    var = torch.clamp(torch.mean(x * x, axes) - mean * mean, min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    col = lambda v: v.view(1, -1, 1, 1)  # noqa: E731
    return (x - col(mean)) * col(mul) + col(bn.bias)


def _todays(bn, x, form, shortcut=None, sc_bn=None):
    """The trunk's expressions before the fused path: relu(batch_norm(...)),
    relu(batch_norm(...) + x), relu(batch_norm(...) + batch_norm(ds, ...)),
    and the stem's max_pool2d(relu(batch_norm(...)))."""
    y = _parent_batch_norm(bn, x)
    if form == "identity":
        y = y + shortcut
    elif form == "downsample":
        y = y + _parent_batch_norm(sc_bn, shortcut)
    y = F.relu(y)
    return F.max_pool2d(y, 3, stride=2, padding=1) if form == "pool" else y


@pytest.mark.parametrize("form", FORMS)
def test_plain_twin_is_todays_expressions(form):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 64, 5, 5, generator=g) * 2 + 1
    s = torch.randn(3, 64, 5, 5, generator=g)
    bn, sc_bn = _bn(64, 2), _bn(64, 3)
    shortcut = s if form in ("identity", "downsample") else None
    ds = sc_bn if form == "downsample" else None
    pool = form == "pool"
    a, a_sc = copy.deepcopy(bn), copy.deepcopy(sc_bn)
    want = _todays(a, x, form, shortcut, a_sc)
    got = bn_fused.bn_relu(bn, x, shortcut, ds, pool=pool)
    assert torch.equal(got, want)
    for m, ref in ((bn, a), (sc_bn, a_sc)):
        assert torch.equal(m.running_mean, ref.running_mean)
        assert torch.equal(m.running_var, ref.running_var)
    before = [t.clone() for t in (bn.running_mean, bn.running_var)]
    assert torch.equal(bn_fused.bn_relu(bn, x, shortcut, ds, update=False, pool=pool), got)
    assert all(torch.equal(t, b) for t, b in zip((bn.running_mean, bn.running_var), before))


@pytest.fixture
def counted(monkeypatch):
    """The custom ops' CPU calls, counted, with the CPU among the kernels'
    device types (so that the model's rule can pick the ops on the CPU)."""
    calls = {"stats": 0, "apply": 0}

    def wrap(key, fn):
        def counted_fn(*args):
            calls[key] += 1
            return fn(*args)
        return counted_fn

    monkeypatch.setattr(bn_fused, "KERNEL_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(bn_fused, "bn_stats_plain", wrap("stats", bn_fused.bn_stats_plain))
    monkeypatch.setattr(bn_fused, "bn_apply_plain", wrap("apply", bn_fused.bn_apply_plain))
    return calls


def _trunk(frozen: bool = True) -> resnet.ResNet18:
    trunk = resnet.ResNet18(generator=torch.Generator().manual_seed(4)).train()
    return trunk.requires_grad_(not frozen)


def _frames(n: int = 2) -> torch.Tensor:
    return torch.randn(n, 1, 67, 67, generator=torch.Generator().manual_seed(5))


def _buffers(m) -> list:
    return [b.clone() for b in m.buffers()]


def test_frozen_trunk_routes_every_batch_norm(counted, monkeypatch):
    """Train mode, frozen: the 20 BatchNorms as 20 statistics and 17 apply
    calls a forward, equal to the plain route, running statistics too; under
    ``running_stats_frozen`` still routed, the statistics left alone."""
    x = _frames()
    trunk = _trunk()
    plain = copy.deepcopy(trunk)
    got = trunk(x)
    assert counted == {"stats": 20, "apply": 17}
    monkeypatch.setattr(bn_fused, "KERNEL_DEVICE_TYPES", ("cuda",))  # the plain route
    want = plain(x)
    assert counted == {"stats": 20, "apply": 17}
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(trunk.buffers(), plain.buffers()))
    monkeypatch.setattr(bn_fused, "KERNEL_DEVICE_TYPES", ("cuda", "cpu"))
    before = _buffers(trunk)
    with resnet.running_stats_frozen():
        assert torch.equal(trunk(x), got)
    assert counted == {"stats": 40, "apply": 34}
    assert all(torch.equal(a, b) for a, b in zip(trunk.buffers(), before))


class _Group:
    """Stands for a data group of two ranks in ``resnet``'s view."""


@pytest.mark.parametrize("case", ["trainable", "eval", "data_group", "input_needs_grad"])
def test_routes_none_where_the_rule_fails(counted, monkeypatch, case):
    """A trainable trunk, eval mode and a set data group take the plain
    route; so does a frozen trunk whose input needs a gradient."""
    x = _frames()
    trunk = _trunk(frozen=case != "trainable")
    if case == "eval":
        trunk.eval()
    if case == "data_group":
        monkeypatch.setattr(resnet, "data_group", lambda: _Group())
        monkeypatch.setattr(resnet, "all_reduce_sum", lambda t, group: t)
    if case == "input_needs_grad":
        x.requires_grad_(True)
    y = trunk(x)
    assert counted == {"stats": 0, "apply": 0}
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("side", [27, 13])
def test_every_frame_size_routes_the_ops(counted, monkeypatch, side):
    """Small frames (27 x 27: layer4 1 x 1; 13 x 13: layer3 and layer4 1 x
    1, where 16 bytes span four channels) route every BatchNorm through the
    ops as the trunk's 67 x 67 do: the rule looks at no shape (the op takes
    any plane, and raises on what it does not take); the forward equals the
    plain route's."""
    x = torch.randn(2, 1, side, side, generator=torch.Generator().manual_seed(5))
    trunk = _trunk()
    plain = copy.deepcopy(trunk)
    got = trunk(x)
    assert counted == {"stats": 20, "apply": 17}
    monkeypatch.setattr(bn_fused, "KERNEL_DEVICE_TYPES", ("cuda",))
    assert torch.equal(got, plain(x))


@pytest.mark.parametrize("shape, ok", [((2, 64, 1, 1), True), ((2, 32, 1, 3), True),
                                       ((1, 2048, 2, 1), True), ((2, 64, 112, 112), True),
                                       ((2, 48, 5, 5), False), ((2, 4096, 1, 1), False),
                                       ((0, 64, 5, 5), False), ((2, 64, 25), False)])
def test_the_ops_check_takes_any_plane(shape, ok):
    """The kernels' check (run before a launch) takes every H x W, 1 x 1 and
    a 112 x 112 stem plane too; it refuses C off a multiple of 32 or over
    MAX_C, an empty tensor and another rank."""
    x = torch.zeros(shape)
    if ok:
        bn_fused._check_x(x)
    else:
        with pytest.raises(ValueError):
            bn_fused._check_x(x)


def _parent_block(block, x):
    """BasicBlock.forward as the plain route computed it before the fused
    path: ds BatchNorm after bn2, the add and the ReLU outside the spans."""
    conv = lambda t, w, s, p: F.conv2d(t, w, stride=s, padding=p)  # noqa: E731
    y = F.relu(_parent_batch_norm(block.bn1, conv(x, block.conv1.weight, block.stride, 1)))
    y = _parent_batch_norm(block.bn2, conv(y, block.conv2.weight, 1, 1))
    residual = x
    if block.has_downsample:
        residual = _parent_batch_norm(block.downsample_bn,
                                      conv(x, block.downsample_conv.weight, block.stride, 0))
    return F.relu(y + residual)


def _parent_trunk(trunk, x):
    k = trunk.conv1.weight.sum(dim=1, keepdim=True)
    x = F.relu(_parent_batch_norm(trunk.bn1, F.conv2d(x, k, stride=2, padding=3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for block in trunk.blocks():
        x = _parent_block(block, x)
    return x.mean(dim=(2, 3))


def test_trainable_trunk_gradients_unchanged(counted):
    """A trainable trunk in train mode: no op call, and every gradient and
    running statistic bit for bit the parent's route."""
    x = _frames()
    trunk = _trunk(frozen=False)
    parent = copy.deepcopy(trunk)
    dy = torch.randn(2, 512, generator=torch.Generator().manual_seed(6))
    (trunk(x) * dy).sum().backward()
    (_parent_trunk(parent, x) * dy).sum().backward()
    assert counted == {"stats": 0, "apply": 0}
    grads = [(n, p.grad) for n, p in trunk.named_parameters()]
    assert len(grads) == 60 and all(g is not None for _, g in grads)
    for (n, g), p in zip(grads, parent.parameters()):
        assert torch.equal(g, p.grad), n
    assert all(torch.equal(a, b) for a, b in zip(trunk.buffers(), parent.buffers()))


@pytest.mark.parametrize("op", ["stats", "apply", "apply_pool"])
def test_ops_register_a_fake_and_a_schema(op):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 32, 5, 5, generator=g)
    v = [torch.rand(32, generator=g) + 0.5 for _ in range(4)]
    if op == "stats":
        args = (x, v[0], v[1], v[2], 1e-5, 0.1, True)
    elif op == "apply":
        args = (x, v[0], v[1], v[2], x.clone(), v[1], v[2], v[3], True, False)
    else:
        args = (x, v[0], v[1], v[2], None, None, None, None, True, True)
    fn = bn_fused.bn_stats if op == "stats" else bn_fused.bn_apply
    torch.library.opcheck(fn, args, test_utils=("test_schema", "test_faketensor"))


# --- on the card ---

# (N, C, H, W): the trunk's five BatchNorm geometries at the AV training step
# (B=16 x T=512 frames; the stem at a quarter of them), then planes of other
# frame sizes: under 4 values (the statistics' scalar path; 16 bytes span up
# to four channels) and a stem plane over the pool's shared memory (frames
# of 224 x 224)
GEOMS = {"stem": (2048, 64, 34, 34), "layer1": (8192, 64, 17, 17),
         "layer2": (8192, 128, 9, 9), "layer3": (8192, 256, 5, 5),
         "layer4": (8192, 512, 3, 3), "hw1": (2048, 512, 1, 1), "hw2": (1024, 64, 1, 2),
         "hw3": (1024, 96, 3, 1), "plane112": (16, 64, 112, 112)}
# |fused - float64| over the channel's sqrt(E[x^2]) (mean) or E[x^2] (var):
# the double sums rounded to fp32 once
STATS_TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _input(n, c, h, w, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    # channel offsets: E[x]^2 a sizeable part of E[x^2], as after a conv
    off = torch.randn(1, c, 1, 1, generator=g, device=dev)
    return torch.randn(n, c, h, w, generator=g, device=dev) * 2 + off


def _stats_err(x, mean, var) -> tuple:
    xd = x.double()
    m64 = xd.mean((0, 2, 3))
    msq = (xd * xd).mean((0, 2, 3))
    v64 = (msq - m64 * m64).clamp(min=0)
    return (((mean.double() - m64).abs() / msq.sqrt()).max().item(),
            ((var.double() - v64).abs() / msq).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(GEOMS))
def test_bn_stats_against_float64(cuda, geom):
    """Mean and variance within STATS_TOL of float64 and no further from it
    than plain torch's (or within an fp32 rounding); mul from the variance as
    plain computes it; the running statistics by plain's update formula on
    these statistics, and near plain's own; a second call bit for bit."""
    n, c, h, w = GEOMS[geom]
    x = _input(n, c, h, w, 1, cuda)
    bn = _bn(c, 8).to(cuda)
    ref = copy.deepcopy(bn)
    r0 = [t.clone() for t in (bn.running_mean, bn.running_var)]
    profiling.reset()
    st = bn_fused.bn_stats(x, bn.weight, bn.running_mean, bn.running_var, bn.eps, bn.momentum,
                           True)
    torch.cuda.synchronize()
    assert profiling.launches() == {bn_fused.STATS_KERNEL: 1}
    plain = bn_fused.bn_stats_plain(x, ref.weight, ref.running_mean, ref.running_var, ref.eps,
                                    ref.momentum, True)
    fused_err, plain_err = _stats_err(x, st[0], st[1]), _stats_err(x, plain[0], plain[1])
    for f, p in zip(fused_err, plain_err):
        assert f < STATS_TOL and f <= max(p, 2.0 ** -23), (fused_err, plain_err)
    assert torch.equal(st[2], torch.rsqrt(st[1] + bn.eps) * bn.weight)
    m = bn.momentum
    assert torch.equal(bn.running_mean, (1 - m) * r0[0] + m * st[0])
    assert torch.equal(bn.running_var, (1 - m) * r0[1] + m * st[1])
    torch.testing.assert_close(bn.running_mean, ref.running_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_var, ref.running_var, rtol=1e-6, atol=1e-6)
    again = bn_fused.bn_stats(x, bn.weight, bn.running_mean.clone(), bn.running_var.clone(),
                              bn.eps, bn.momentum, True)
    assert torch.equal(again, st)
    frozen = [t.clone() for t in (bn.running_mean, bn.running_var)]
    assert torch.equal(bn_fused.bn_stats(x, bn.weight, bn.running_mean, bn.running_var, bn.eps,
                                         bn.momentum, False), st)
    assert torch.equal(bn.running_mean, frozen[0]) and torch.equal(bn.running_var, frozen[1])


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(GEOMS))
def test_bn_apply_bit_for_bit_given_plain_stats(cuda, geom):
    """With plain's statistics, each epilogue (none, + shortcut, + the
    shortcut's own normalisation, the 3x3/2 max pool) with and without ReLU
    equals the plain version bit for bit; one launch a call; a second call
    the same."""
    n, c, h, w = GEOMS[geom]
    x, s = _input(n, c, h, w, 2, cuda), _input(n, c, h, w, 3, cuda)
    bn, sc_bn = _bn(c, 9).to(cuda), _bn(c, 10).to(cuda)
    st = bn_fused.bn_stats_plain(x, bn.weight, bn.running_mean, bn.running_var, bn.eps, 0.1,
                                 False)
    sd = bn_fused.bn_stats_plain(s, sc_bn.weight, sc_bn.running_mean, sc_bn.running_var,
                                 sc_bn.eps, 0.1, False)
    epilogues = {"none": (None, None, None, None, False), "identity": (s, None, None, None, False),
                 "downsample": (s, sd[0], sd[2], sc_bn.bias, False),
                 "pool": (None, None, None, None, True)}
    for name, (*extra, pool) in epilogues.items():
        for relu in (False, True):
            args = (x, st[0], st[2], bn.bias, *extra, relu, pool)
            profiling.reset()
            got = bn_fused.bn_apply(*args)
            torch.cuda.synchronize()
            assert profiling.launches() == {bn_fused.APPLY_KERNEL: 1}
            assert torch.equal(got, bn_fused.bn_apply_plain(*args)), (name, relu)
            assert torch.equal(bn_fused.bn_apply(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["rank", "dtype", "noncontiguous", "channels", "shortcut",
                                 "vector"])
def test_ops_raise_on_what_the_kernels_do_not_take(cuda, bad):
    x = _input(4, 64, 5, 5, 4, cuda)
    v = torch.rand(64, device=cuda) + 0.5
    shortcut = None
    if bad == "rank":
        x = x.reshape(4, 64, 25)
    elif bad == "dtype":
        x = x.double()
    elif bad == "noncontiguous":
        x = x.contiguous(memory_format=torch.channels_last)
    elif bad == "channels":
        x = x[:, :48].contiguous()
        v = v[:48].contiguous()
    elif bad == "shortcut":
        shortcut = x[:2].clone()
    elif bad == "vector":
        v = v.double()
    profiling.reset()
    with pytest.raises(ValueError):
        bn_fused.bn_apply(x, v, v, v, shortcut, None, None, None, True, False)
    if bad != "shortcut":
        with pytest.raises(ValueError):
            bn_fused.bn_stats(x, v, v.clone(), v.clone(), 1e-5, 0.1, True)
    assert profiling.launches() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("side", [67, 27, 13, 224])
def test_frozen_trunk_at_other_frame_sizes_on_the_kernels(cuda, monkeypatch, side):
    """A frozen trunk in train mode, TF32 off, at frames of 67 x 67 (the
    trunk's), 27 x 27 (layer4 1 x 1), 13 x 13 (layer3 and layer4 1 x 1) and
    224 x 224 (a 112 x 112 stem plane): 20 statistics and 17 apply launches;
    against the same trunk in float64, the features no further off than the
    plain route's (within 1.5 times its worst and mean error) and within
    1e-5 of the features' largest value of the plain route's; the running
    statistics within 1e-6 relative of float64's."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n = 64 if side < 224 else 8
    x = torch.randn(n, 1, side, side, generator=torch.Generator().manual_seed(5)).to(cuda)
    trunk = _trunk().to(cuda)
    plain = copy.deepcopy(trunk)
    t64 = resnet.ResNet18(generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    t64.load_state_dict(trunk.state_dict())
    t64 = t64.train().requires_grad_(False).to(cuda)
    profiling.reset()
    got = trunk(x).double()
    torch.cuda.synchronize()
    assert profiling.launches() == {bn_fused.STATS_KERNEL: 20, bn_fused.APPLY_KERNEL: 17}
    monkeypatch.setattr(bn_fused, "KERNEL_DEVICE_TYPES", ())
    want = plain(x).double()
    ref = t64(x.double())
    err = {k: (v - ref).abs() for k, v in (("fused", got), ("plain", want))}
    assert err["fused"].max() <= 1.5 * err["plain"].max()
    assert err["fused"].mean() <= 1.5 * err["plain"].mean()
    assert (got - want).abs().max() <= 1e-5 * ref.abs().max()
    for a, b in zip(trunk.buffers(), t64.buffers()):
        if a.is_floating_point():
            assert ((a.double() - b.double()).abs().max() <= 1e-6 * b.double().abs().max())


@pytest.mark.cuda
def test_frozen_trunk_av_train_step_matches_plain(cuda, monkeypatch):
    """One AV train step (frozen trunk in train mode, MCB 128, 2 x LSTM 64,
    B=2, T=64) on the fused BatchNorms (20 statistics and 17 apply launches)
    against the same step on the plain route: the loss within the
    benchmark's 6e-7 relative, the trainable gradients within 1e-4."""
    from avvad_tpu_torch.data import Batch
    from avvad_tpu_torch.models import AVVAD
    from avvad_tpu_torch.train import create_train_state, make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(3)
    b, t = 2, 64
    lengths = np.array([t, 40])
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    batch = Batch(audio=rng.normal(size=(b, t, 513)).astype(np.float32),
                  video=rng.normal(size=(b, t, 67, 67)).astype(np.float32),
                  label=(rng.random((b, t, 1)) > 0.5).astype(np.float32),
                  lengths=lengths, mask=mask)
    model = AVVAD(lstm_hidden_size=64, lstm_layers=2, mcb_output_size=128,
                  use_kernel_lstm=True)
    results = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(bn_fused, "KERNEL_DEVICE_TYPES", ())
        state = create_train_state(copy.deepcopy(model), freeze_video_trunk=True, device=cuda)
        profiling.reset()
        state, metrics = make_train_step("av")(state, batch)
        torch.cuda.synchronize()
        counts = profiling.launches()
        want = {bn_fused.STATS_KERNEL: 20, bn_fused.APPLY_KERNEL: 17} if fused else {}
        assert {k: counts.get(k, 0) for k in want} == want
        results.append((float(metrics["loss"]),
                        {n: p.grad for n, p in state.model.named_parameters()
                         if p.grad is not None}))
    (l_f, g_f), (l_p, g_p) = results
    assert abs(l_f - l_p) / abs(l_p) < 6e-7
    assert g_f.keys() == g_p.keys() and g_f
    for n in g_f:
        assert ((g_f[n] - g_p[n]).norm() / g_p[n].norm().clamp(min=1e-12)).item() < 1e-4, n
