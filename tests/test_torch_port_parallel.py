"""The port's meshes, placements, the data x model train step, the
meshed ``evaluate_split``, the sharded multi-stream servers and their
artifacts, and the multi-device dry run, on the CPU.

Collective programs run one gloo rank a mesh position, launched through
``avvad_tpu_torch.parallel.spawn`` (each launch with its own time limit;
a failing rank kills the others and raises with its output); their rank
functions are in ``tests/test_torch_port_ranks.py``. The JAX side (the
data 4 x model 2 AudioVAD step) runs on the 8 virtual CPU devices of
``tests/conftest.py``, as ``tests/test_parallel.py`` does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.data.batching import Batch as JBatch
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.parallel import make_mesh as jmake_mesh
from avvad_tpu.parallel import shard_batch as jshard_batch
from avvad_tpu.parallel import shard_opt_state as jshard_opt_state
from avvad_tpu.parallel import shard_params as jshard_params
from avvad_tpu.train import create_train_state as jcreate_train_state
from avvad_tpu.train import make_train_step as jmake_train_step
from avvad_tpu.train.state import make_optimizer as jmake_optimizer
from avvad_tpu_torch import serve
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.export import export_multistream_server, load_multistream_server
from avvad_tpu_torch.models import AVVAD, AudioVAD, VideoVAD
from avvad_tpu_torch.parallel import (Placement, batch_sharding, make_mesh,
                                      opt_sharding_tree, param_sharding_rules,
                                      replicated, shard_batch, shard_params,
                                      sharding_tree, spawn)
from avvad_tpu_torch.train import create_train_state, make_train_step

import test_torch_port_ranks as worker

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_S = 120  # each launch's limit
LR = 1e-4


def _spawn(fn, n, *args, timeout_s=SPAWN_S):
    return spawn(f"test_torch_port_ranks:{fn}", n, args=args, timeout_s=timeout_s,
                 paths=[HERE])


# --- meshes and placements ------------------------------------------------------


def test_mesh_construction():
    mesh = make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8)
    assert mesh.devices.shape == (4, 2) and mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh(devices=["cpu"] * 8).devices.shape == (8, 1)
    assert make_mesh(n_model=2, devices=["cpu"] * 8).shape == {"data": 4, "model": 2}
    if torch.cuda.is_available():
        assert make_mesh().devices.size == torch.cuda.device_count()
    else:  # no quiet fallback: a mesh on the CPU is asked for by name
        with pytest.raises(RuntimeError, match="runs on a CUDA device by default"):
            make_mesh()
    with pytest.raises(ValueError):
        make_mesh(n_data=3, n_model=2, devices=["cpu"] * 8)


def test_tp_sharding_rules_target_wide_lstm_kernels():
    big, small = torch.zeros(513, 4096), torch.zeros(513, 128)
    assert param_sharding_rules(("lstm", "w_ih"), big) == (None, "model")
    assert param_sharding_rules("lstm_audio.layer_0.w_hh", big) == (None, "model")
    assert param_sharding_rules(("lstm", "w_ih"), small) == ()
    assert param_sharding_rules(("conv1", "kernel"), big) == ()
    assert param_sharding_rules("lstm.bias", torch.zeros(4096)) == ()


def test_sharding_trees_place_moments_like_their_params():
    """The placements shard_params / shard_opt_state give: the H=512
    LSTM's w_ih / w_hh (4H = 2048 columns) on `model`, the rest
    replicated, and Adam's moments like their parameter."""
    mesh = make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8)
    model = AudioVAD(lstm_hidden_size=worker.TP_H, lstm_layers=2)
    tree = sharding_tree(mesh, model)
    sharded = {n for n, pl in tree.items() if pl.spec == (None, "model")}
    assert sharded == {f"lstm_audio.layer_{i}.{w}" for i in (0, 1) for w in ("w_ih", "w_hh")}
    assert all(pl == replicated(mesh) for n, pl in tree.items() if n not in sharded)
    moments = opt_sharding_tree(mesh, model)
    for name, pl in tree.items():
        assert moments[name]["exp_avg"] == moments[name]["exp_avg_sq"] == pl
        assert moments[name]["step"] == replicated(mesh)
    assert batch_sharding(mesh) == Placement(mesh, ("data",))
    narrow = sharding_tree(mesh, AudioVAD(lstm_hidden_size=32, lstm_layers=1))
    assert all(pl.spec == () for pl in narrow.values())


def test_collectives_need_one_rank_a_position():
    """No quiet fallback: a collective program on a mesh larger than the
    process group raises, as does sharding weights without a group;
    indivisible batches raise; without a group the process is rank 0."""
    mesh = make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="process group has 1 rank"):
        mesh.group("data")
    with pytest.raises(ValueError, match="process group has 1 rank"):
        shard_params(mesh, AudioVAD(lstm_hidden_size=worker.TP_H, lstm_layers=1))
    with pytest.raises(ValueError, match="process group has 1 rank"):
        make_train_step("audio", mesh=mesh)
    batch = worker.audio_batch()
    local = shard_batch(mesh, batch)
    np.testing.assert_array_equal(local.audio, batch.audio[:2])
    assert local.label.shape == (2, 12, 1) and local.video is None
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, worker.audio_batch(b=6))
    one = make_mesh(1, 1, devices=["cpu"])
    assert one.group("data") is None and one.local_device == torch.device("cpu")


# --- data 4 x model 2: the port against itself unmeshed and against JAX ---------


@pytest.fixture(scope="module")
def dp_tp(tmp_path_factory):
    """JAX's AudioVAD(H=512) init -> the port's weights; JAX's data 4 x
    model 2 step (plain scan) and the port's, on 8 gloo ranks, for the
    plain recurrence and the kernel route; the unmeshed port steps."""
    tmp = tmp_path_factory.mktemp("dp_tp")
    jm = JAudioVAD(y_dim=1, lstm_hidden_size=worker.TP_H, lstm_layers=2)
    batch = worker.audio_batch()
    jbatch = JBatch(audio=jnp.asarray(batch.audio), video=None,
                    label=jnp.asarray(batch.label), lengths=jnp.asarray(batch.lengths),
                    mask=jnp.asarray(batch.mask))
    jstate = jcreate_train_state(jm, jax.random.PRNGKey(0), (jnp.zeros((1, 4, 513)),),
                                 jmake_optimizer(LR))
    weights = from_flax_variables({"params": jax.tree_util.tree_map(np.asarray,
                                                                    jstate.params)})
    wpath = str(tmp / "weights.pt")
    torch.save(weights, wpath)
    jmesh = jmake_mesh(n_data=4, n_model=2)
    with jmesh:
        sharded = jstate.replace(params=jshard_params(jmesh, jstate.params),
                                 opt_state=jshard_opt_state(jmesh, jstate.opt_state))
        jnew, jmetrics = jmake_train_step("audio", donate=False)(
            sharded, jshard_batch(jmesh, jbatch), None)
    jfinal = from_flax_variables({"params": jax.tree_util.tree_map(np.asarray,
                                                                   jnew.params)})
    reports = _spawn("dp_tp_audio_step", 8, 4, 2, wpath, str(tmp))
    single = {}
    for route, use_kernel in (("plain", False), ("kernel", True)):
        model = AudioVAD(lstm_hidden_size=worker.TP_H, lstm_layers=2,
                         use_kernel_lstm=use_kernel)
        model.load_state_dict(weights)
        state = create_train_state(model, learning_rate=LR, device="cpu")
        with worker.one_thread():
            _, metrics = make_train_step("audio")(state, batch)
        single[route] = ({k: float(v) for k, v in metrics.items()},
                         {k: v.clone() for k, v in model.state_dict().items()})
    meshed = {r: torch.load(str(tmp / f"{r}.pt"), weights_only=True)
              for r in ("plain", "kernel")}
    return {"reports": reports, "single": single, "meshed": meshed,
            "jax": (float(jmetrics["loss"]), jfinal)}


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_dp_tp_step_matches_unmeshed_step(dp_tp, route):
    """Loss rtol 1e-5 and every updated parameter, the column-sharded
    LSTM weights gathered, rtol 1e-4 / atol 1e-5 against the unmeshed
    port step on the global batch (the bars of tests/test_parallel.py);
    metrics are the global batch's on every rank."""
    metrics, params = dp_tp["single"][route]
    for r in dp_tp["reports"]:
        np.testing.assert_allclose(r[route]["loss"], metrics["loss"], rtol=1e-5)
        for k in ("accuracy", "precision", "recall", "f1"):
            np.testing.assert_allclose(r[route][k], metrics[k], rtol=1e-6)
    got = dp_tp["meshed"][route]
    assert set(got) == set(params)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), params[k].numpy(), rtol=1e-4, atol=1e-5)


def test_dp_tp_step_matches_jax_mesh_step(dp_tp):
    """The port's data 4 x model 2 step against JAX's on its 8 virtual
    devices (the plain recurrence: JAX's scan), same weights and batch."""
    loss, final = dp_tp["jax"]
    got = dp_tp["meshed"]["plain"]
    for r in dp_tp["reports"]:
        np.testing.assert_allclose(r["plain"]["loss"], loss, rtol=1e-5)
    for k in final:
        np.testing.assert_allclose(got[k].numpy(), final[k], rtol=1e-4, atol=1e-5)


def test_dp_tp_ranks_hold_their_rows_and_column_shards(dp_tp):
    """Rank r at (r // 2, r % 2) holds the rows of its data coordinate
    (ranks along `model` the same rows), the columns 1024 * (r % 2) ... of
    each (D, 2048) w_ih / w_hh, and Adam moments of the shard's shape."""
    for rank, r in enumerate(dp_tp["reports"]):
        d, m = rank // 2, rank % 2
        assert r["coords"] == [d, m]
        assert r["rows"] == [2 * d, 2 * d + 1] and r["slice"] == [2 * d, 2 * d + 2]
        for route in ("plain", "kernel"):
            shards = r[route]["shards"]
            assert sorted(shards) == sorted(
                f"lstm_audio.layer_{i}.parametrizations.{w}.original"
                for i in (0, 1) for w in ("w_ih", "w_hh"))
            for name, shape in shards.items():
                rows = 513 if "layer_0.parametrizations.w_ih" in name else worker.TP_H
                assert shape == [rows, 2 * worker.TP_H]
                assert r[route]["moments"][name] == [shape, shape]


# --- evaluate_split over a mesh ---------------------------------------------------


@pytest.fixture(scope="module")
def meshed_eval(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    return _spawn("meshed_evaluate", 2, str(tmp / "meshed")), tmp


@pytest.mark.parametrize("tower", ["float", "int8"])
def test_meshed_evaluate_split_writes_the_unmeshed_files(meshed_eval, tower):
    """Two ranks, data 2, batch 4 over six utterances: the same .npy
    files as the unmeshed run, within 1e-6 (tests/test_evaluate.py:200),
    and the same global counts on both ranks."""
    from avvad_tpu_torch.evaluate import evaluate_split

    reports, tmp = meshed_eval
    meshed, single = tmp / "meshed" / tower, tmp / "single" / tower
    with worker.one_thread():
        ref = evaluate_split(create_train_state(worker.eval_model(tower == "int8"),
                                                device="cpu"),
                             worker.TinySource(6), "av", str(single), batch_size=4,
                             bucket=8, verbose=False)
    for r in reports:
        assert r[tower]["n_utterances"] == ref["n_utterances"] == 6
        assert r[tower]["n_frames"] == ref["n_frames"]
    want = sorted(p.relative_to(single) for p in single.rglob("*.npy"))
    assert len(want) == 12
    assert sorted(p.relative_to(meshed) for p in meshed.rglob("*.npy")) == want
    for rel in want:
        a, b = np.load(meshed / rel), np.load(single / rel)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_meshed_evaluate_split_needs_divisible_batches():
    from avvad_tpu_torch.evaluate import evaluate_split

    state = create_train_state(worker.tiny_audio_model(), device="cpu")
    two = make_mesh(2, 1, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="process group has 1 rank"):
        evaluate_split(state, worker.TinySource(2), "audio", "unused", batch_size=4,
                       mesh=two)
    two.check_world = lambda: None  # the divisibility check comes first
    with pytest.raises(ValueError, match="not divisible by data axis 2"):
        evaluate_split(state, worker.TinySource(2), "audio", "unused", batch_size=3,
                       mesh=two)


# --- sharded multi-stream servers -------------------------------------------------

H = 16
MESH8 = ["cpu"] * 8


def _mesh8():
    return make_mesh(n_data=8, n_model=1, devices=MESH8)


def _sigs(n=8, seed=5, length=9000):
    rng = np.random.default_rng(seed)
    sigs = [np.clip(rng.normal(size=length) * 0.3, -1, 1).astype(np.float32)
            for _ in range(n)]
    for s in sigs:
        s[0] = 1.0  # pin the causal peak
    return sigs


def _frames(n, seed):
    return np.round(np.random.default_rng(seed).random((n, 67, 67)) * 255).astype(np.float32)


def _collect(outs, tick):
    for i, p in tick.items():
        outs[i].append(np.asarray(p))


def _cat(outs):
    return [np.concatenate(o) if o else np.zeros(0) for o in outs]


# a shard runs one row where the unsharded step runs eight: the CPU BLAS
# picks another kernel, and the carries (c unbounded, up to ~5 here) drift
# by its rounding over the ticks (1.8e-5 relative seen); the probabilities
# stay within 1e-6
PROB_ATOL, CARRY_RTOL, CARRY_ATOL = 1e-6, 1e-4, 1e-6


def _check_same(ref_srv, got_srv, ref, got):
    for r, g in zip(ref, got):
        assert len(g) == len(r)
        np.testing.assert_allclose(g, r, atol=PROB_ATOL)
    for (hr, cr), (hg, cg) in zip(ref_srv._carries, got_srv._carries):
        for g, r in ((hg, hr), (cg, cr)):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=CARRY_RTOL,
                                       atol=CARRY_ATOL)


@pytest.fixture
def one_thread():
    """Eight shards run eight small steps a tick (see worker.one_thread)."""
    with worker.one_thread():
        yield


@pytest.fixture(scope="module")
def audio_model():
    return AudioVAD(lstm_hidden_size=H, lstm_layers=2, seed=1)


@pytest.mark.parametrize("pipelined", [False, True])
def test_sharded_multistream_vad_matches_unsharded(audio_model, pipelined, one_thread):
    """8 streams sharded 8 ways (tests/test_parallel.py:159-240): same
    feeds, a stream reset in the middle, six ticks (or pipelined ticks and
    the flush): the probabilities and the carries of every stream equal
    the unsharded server's."""
    sigs = _sigs()

    def run(mesh):
        ms = serve.MultiStreamVAD(audio_model, n_streams=8, block_frames=8,
                                  max_backlog_blocks=256, device="cpu", mesh=mesh)
        ms.warmup()
        outs = [[] for _ in range(8)]
        for i, s in enumerate(sigs):
            ms.feed(i, s)
        ms.reset_stream(3)
        ms.feed(3, sigs[3][:5000])
        for _ in range(6):
            _collect(outs, ms.tick_pipelined() if pipelined else ms.tick())
        if pipelined:
            _collect(outs, ms.flush_pipelined())
        return ms, _cat(outs)

    ref_srv, ref = run(None)
    got_srv, got = run(_mesh8())
    assert got_srv.mesh_data == 8 and ref_srv.mesh_data is None
    assert len(got_srv._shards) == 8 and {sh.hi - sh.lo for sh in got_srv._shards} == {1}
    _check_same(ref_srv, got_srv, ref, got)


def test_sharded_multistream_avvad_matches_unsharded(one_thread):
    """MCB fusion (the per-stream L2 norm), span int16 wire, camera-rate
    uint8 video, a dripping video gate and a stream reset."""
    model = AVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=32, seed=2)
    sigs = [(s * 20000).astype(np.int16) for s in _sigs(seed=6)]
    vids = [_frames(60, 10 + i) for i in range(8)]

    def run(mesh):
        ms = serve.MultiStreamAVVAD(model, n_streams=8, block_frames=8,
                                    max_backlog_blocks=256, span_wire=True,
                                    audio_int16=True, video_fps=30.0, video_uint8=True,
                                    device="cpu", mesh=mesh)
        outs = [[] for _ in range(8)]
        for i in range(8):
            ms.feed(i, pcm=sigs[i], video_frames=vids[i][:8 + 2 * i])
        for t in range(4):
            if t == 2:
                ms.reset_stream(5)
                ms.feed(5, pcm=sigs[5][:6000], video_frames=vids[5][:20])
            for i in range(8):
                ms.feed(i, video_frames=vids[i][8 + 2 * i + 4 * t: 12 + 2 * i + 4 * t])
            _collect(outs, ms.tick())
        return ms, _cat(outs)

    ref_srv, ref = run(None)
    got_srv, got = run(_mesh8())
    assert sum(len(r) for r in ref) > 0
    _check_same(ref_srv, got_srv, ref, got)


@pytest.mark.parametrize("int8", [False, True], ids=["float_tower", "int8_tower"])
def test_sharded_multistream_video_vad_matches_unsharded(int8, one_thread):
    """The video-only server with the float tower, and with the
    static-int8 tower on its fused route (the CPU runs the plain K3 / K2;
    each shard keeps its own fold), label-rate frames, pipelined."""
    model = VideoVAD(lstm_hidden_size=H, lstm_layers=1, tower_int8=int8,
                     tower_quant_mode="static" if int8 else "dynamic",
                     tower_pallas=int8, seed=3)
    if int8:
        with torch.no_grad():
            for n, b in model.named_buffers():
                if n.rsplit(".", 1)[-1] in ("q_stem", "q1", "q_out"):
                    b.fill_(4.0)
    vids = [_frames(24, 20 + i) for i in range(8)]

    def run(mesh):
        ms = serve.MultiStreamVideoVAD(model, n_streams=8, block_frames=4,
                                       max_backlog_blocks=64, device="cpu", mesh=mesh)
        ms.warmup()
        outs = [[] for _ in range(8)]
        for i in range(8):
            ms.feed(i, video_frames=vids[i][:4 + 4 * (i % 3)])
        for t in range(3):
            _collect(outs, ms.tick_pipelined())
            for i in range(8):
                ms.feed(i, video_frames=vids[i][4 + 4 * (i % 3) + 4 * t:
                                                8 + 4 * (i % 3) + 4 * t])
        _collect(outs, ms.flush_pipelined())
        return ms, _cat(outs)

    ref_srv, ref = run(None)
    got_srv, got = run(_mesh8())
    assert sum(len(r) for r in ref) > 0
    _check_same(ref_srv, got_srv, ref, got)
    if int8:
        folds = {id(sh.view.model.tower.features._fold) for sh in got_srv._shards}
        assert len(folds) == 8  # one replica, one fold a shard


def test_sharded_server_needs_divisible_streams(audio_model):
    with pytest.raises(ValueError, match="divisible"):
        serve.MultiStreamVAD(audio_model, n_streams=6, block_frames=8, device="cpu",
                             mesh=_mesh8())


def test_mesh_sharded_server_artifact(tmp_path, audio_model, one_thread):
    """A mesh-sharded server round-trips through its artifact
    (tests/test_export.py:330): the shard's tick replays on every shard of
    the rebuilt server (by default over the first 8 local devices), which
    equals the unsharded live server; a mesh with another data axis
    raises with JAX's wording."""
    sharded = serve.MultiStreamVAD(audio_model, n_streams=8, block_frames=4,
                                   device="cpu", mesh=_mesh8())
    plain = serve.MultiStreamVAD(audio_model, n_streams=8, block_frames=4, device="cpu")
    p = str(tmp_path / "mesh_server.avvadx")
    export_multistream_server(sharded, p)
    loaded = load_multistream_server(p)
    assert loaded.mesh_data == 8 and loaded._dev == torch.device("cpu")
    rng = np.random.default_rng(0)
    pcm = [rng.standard_normal(1024 + 256 * 7).astype(np.float32) for _ in range(8)]
    for i in range(8):
        plain.feed(i, pcm[i])
        loaded.feed(i, pcm[i])
    for _ in range(2):
        want, got = plain.tick(), loaded.tick()
        assert set(want) == set(got) == set(range(8))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6)
    with pytest.raises(ValueError, match="exported for data axis 8, got mesh data axis 4"):
        load_multistream_server(p, mesh=make_mesh(n_data=4, devices=["cpu"] * 4))
    again = load_multistream_server(p, mesh=_mesh8())
    assert again.mesh_data == 8


# --- the dry run -------------------------------------------------------------------


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """The full-width AV step (MCB 1024, 2 x LSTM 1024, ResNet-18 frozen)
    over data 2 x model 2 on four gloo ranks, the checkpoint round trip
    and a sharded serving tick: its three ok lines."""
    from avvad_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, timeout_s=SPAWN_S)
    out = capsys.readouterr().out
    assert "dryrun_multichip(n=4, mesh=data2xmodel2): loss=" in out
    assert "checkpoint round-trip + post-restore step: loss=" in out
    assert "serving mesh tick over 2 devices: 2 streams ok" in out
