"""Data and context parallel training of the port, on the CPU.

The layout logic without processes: the mesh's sizes and errors against
the JAX package's rank grid, JAX's tests/test_multihost.py cases on (host,
rank) records, ``process_batch_slice``, ``shard_batch``'s rows, time
shards and padding, ``build_model``'s ``cp_axis`` errors and the parameter
fingerprint's count against JAX's on the tiny model.

Then one gloo world of four processes (tests/torch_dist_cases.py) at dp 2 x
cp 2: the tiny model's train step for ``gla``, ``rwkv6`` and ``mamba`` on a
batch of ragged valid counts, held against the JAX package's single-device
step on the whole batch (weights carried by the bridge, no dropout, no text
masking): loss and accuracy within rtol 1e-4 (tests/test_torch_train.py's
bound), every parameter gradient within 3e-4 of its own max|ref|; ``train.cli
fit`` from the tiny YAML, whose losses equal the single-process run's, a
dp 1 checkpoint resumed at dp 2 x cp 2 and theirs at dp 1 (the same step
as dp 1 resuming its own); a codec
GAN step at dp 2 against the single-process step on the whole batch; the
VQ's EMA update and dead-code expiry at dp 2; ``assert_replicated``
passing, then failing on a perturbed rank.
"""
import dataclasses
import json
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny as jax_tiny
from lina_speech_tpu.models.accuracy import topk_accuracy as jax_topk
from lina_speech_tpu.parallel.mesh import MeshConfig as JaxMeshConfig, make_mesh as jax_make_mesh
from lina_speech_tpu_torch.codec import vq as tvq
from lina_speech_tpu_torch.config import build_model, lina_gla_tiny
from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
from lina_speech_tpu_torch.models.mamba import perturb_mamba_params_
from lina_speech_tpu_torch.models.rwkv6 import perturb_rwkv6_params_
from lina_speech_tpu_torch.parallel import MeshConfig, make_mesh, process_batch_slice, shard_batch
from lina_speech_tpu_torch.parallel.checks import param_count_fingerprint
from lina_speech_tpu_torch.parallel.mesh import Mesh, mesh_shape, rank_grid
from lina_speech_tpu_torch.parallel.multihost import (
    RankRecord, backend_for, device_order, distributed_init, make_multihost_mesh,
    validate_tp_intra_host,
)
from lina_speech_tpu_torch.train import cli
from lina_speech_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint
from lina_speech_tpu_torch.utils.convert import named_tensors_to_jax
from torch_dist_cases import TINY, World, codec_gan_reference, tiny_cfg

KINDS = ("gla", "rwkv6", "mamba")
TOL_METRIC = 1e-4  # rtol, as tests/test_torch_train.py
TOL_GRAD = 3e-4  # of each gradient's own max|ref|


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ the layout
def test_mesh_shape_sizes_and_errors():
    assert mesh_shape(MeshConfig(), 8) == (8, 1, 1)
    assert mesh_shape(MeshConfig(cp=2), 8) == (4, 1, 2)
    assert mesh_shape(MeshConfig(dp=2, cp=4), 8) == (2, 1, 4)
    with pytest.raises(ValueError, match="world size 8"):
        mesh_shape(MeshConfig(dp=2, cp=2), 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11b"):
        mesh_shape(MeshConfig(tp=2), 8)
    mesh = make_mesh()  # no torch.distributed world: one rank, no groups
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.group("dp", "cp") is None
    for config in (MeshConfig(dp=2), MeshConfig(cp=4)):
        with pytest.raises(ValueError, match="world size 1"):
            make_mesh(config)


@pytest.mark.parametrize("config", [dict(dp=2, cp=4), dict(dp=8), dict(dp=4, cp=2)], ids=str)
def test_rank_grid_is_the_jax_mesh_layout(config):
    """cp innermost, as JAX's make_mesh lays its 8 virtual devices out."""
    jm = jax_make_mesh(JaxMeshConfig(tp=1, **config))
    grid = rank_grid(range(8), MeshConfig(**config))
    np.testing.assert_array_equal(grid, np.vectorize(lambda d: d.id)(jm.devices))
    names = ("dp", "tp", "cp") if config.get("cp", 1) > 1 else ("dp", "tp")
    assert jm.axis_names == names


def _records(n_hosts, per_host, interleave=False):
    return [RankRecord(process_index=h, id=(i * n_hosts + h) if interleave else h * per_host + i)
            for h in range(n_hosts) for i in range(per_host)]


def test_device_order_is_host_major():
    ordered = device_order(_records(4, 4, interleave=True))
    hosts = [d.process_index for d in ordered]
    assert hosts == sorted(hosts)
    for h in range(4):
        ids = [d.id for d in ordered if d.process_index == h]
        assert ids == sorted(ids)


def test_tp_intra_host_validation():
    ordered = device_order(_records(2, 4))
    validate_tp_intra_host(ordered, 4)
    validate_tp_intra_host(ordered, 2)
    with pytest.raises(ValueError, match="straddle"):
        validate_tp_intra_host(ordered, 8)


def test_multihost_layout_puts_dp_across_hosts():
    """JAX's 2-host x 4-rank case: with tp 2 each tp pair inside one host,
    dp split across the boundary (the rank grid of make_multihost_mesh)."""
    ordered = device_order(_records(2, 4, interleave=True))
    validate_tp_intra_host(ordered, 2)
    arr = np.asarray(ordered, dtype=object).reshape(4, 2)
    for row in arr:
        assert len({d.process_index for d in row}) == 1
    assert {d.process_index for d in arr[:2].ravel()} == {0}
    assert {d.process_index for d in arr[2:].ravel()} == {1}
    # a single process: the plain make_mesh mesh; tp still raises item 11b
    assert make_multihost_mesh().shape == make_mesh().shape
    with pytest.raises(NotImplementedError, match="item 11b"):
        make_multihost_mesh(MeshConfig(dp=4, tp=2), _records(2, 4))


def test_process_batch_slice_and_distributed_init_single_process(monkeypatch):
    assert process_batch_slice(16, process_index=0, process_count=4) == slice(0, 4)
    assert process_batch_slice(16, process_index=3, process_count=4) == slice(12, 16)
    with pytest.raises(ValueError, match="divisible"):
        process_batch_slice(10, process_index=0, process_count=4)
    assert process_batch_slice(6) == slice(0, 6)  # one process
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed_init(device="cpu") is False  # no world to join: a no-op
    with pytest.raises(ValueError, match="rank"):
        distributed_init("localhost:1", device="cpu")
    assert backend_for("cpu") == "gloo" and backend_for("cuda:1") == "nccl"


def _fake_mesh(dp, cp, rank):
    grid = np.arange(dp * cp).reshape((dp, 1, cp) if cp > 1 else (dp, 1))
    return Mesh(grid, ("dp", "tp", "cp") if cp > 1 else ("dp", "tp"), rank, {})


def _batch(batch_size=4, lo=9, hi=26, seed=3):
    return next(synthetic_tts_batches(batch_size=batch_size, n_quant=1, n_codebook=50,
                                      min_audio_len=lo, max_audio_len=hi, seed=seed,
                                      structured=True))


def test_shard_batch_rows_time_shards_and_padding():
    batch = _batch()
    b, n = batch["audio_token"].shape[:2]
    # rows: dp 2 inside each of 2 micro-batches, as JAX shards each slice
    got = [shard_batch(batch, _fake_mesh(2, 1, r), micro_batches=2)["text_token"]
           for r in range(2)]
    np.testing.assert_array_equal(got[0], batch["text_token"][[0, 2]])
    np.testing.assert_array_equal(got[1], batch["text_token"][[1, 3]])
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch, _fake_mesh(2, 1, 0), micro_batches=4)
    # time under cp 3: the n - 1 inputs padded to a multiple of 3, each rank
    # t + 1 frames, the last its next rank's first
    cp = 3
    t = -(-(n - 1) // cp)
    parts = [shard_batch(batch, _fake_mesh(1, cp, r)) for r in range(cp)]
    for key in ("audio_token", "y_mask", "crossatt_mask"):
        assert all(p[key].shape[1] == t + 1 for p in parts)
        inputs = np.concatenate([p[key][:, :-1] for p in parts], 1)
        targets = np.concatenate([p[key][:, 1:] for p in parts], 1)
        np.testing.assert_array_equal(inputs[:, :n - 1], batch[key][:, :-1])
        np.testing.assert_array_equal(targets[:, :n - 1], batch[key][:, 1:])
        pad = targets[:, n - 1:]
        if key == "crossatt_mask":  # padded rows see text position 0 only
            assert pad[..., 0].all() and not pad[..., 1:].any()
        else:
            assert not pad.any()
    for key in ("text_token", "encoder_mask"):  # the text is whole on every rank
        assert all(np.array_equal(p[key], batch[key]) for p in parts)


def test_cp_axis_needs_a_mesh_carrying_it():
    cfg = lina_gla_tiny()
    cp = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, cp_axis="cp"))
    for mesh in (None, make_mesh()):  # no mesh, a mesh without a cp axis
        with pytest.raises(ValueError, match="not an axis of the mesh"):
            build_model(cp, device="cpu", mesh=mesh)
    tf = dataclasses.replace(cp, backbone=dataclasses.replace(cp.backbone, kind="transformer"))
    with pytest.raises(ValueError, match="transformer"):
        build_model(tf, device="cpu", mesh=_fake_mesh(1, 2, 0))


def test_fit_cp_refuses_the_transformer(tmp_path):
    """``fit --cp 2`` on the transformer raises before it starts a world, as
    the JAX CLI refuses it."""
    cfg = tmp_path / "transformer.yaml"
    with open(TINY) as src:
        cfg.write_text(src.read().replace("kind: gla", "kind: transformer"))
    with pytest.raises(ValueError, match="transformer"):
        cli.main(["fit", "--config", str(cfg), "--device", "cpu", "--cp", "2"])


def test_param_count_fingerprint_matches_jax():
    model = build_model(lina_gla_tiny(), device="cpu")
    jm = jax_build(jax_tiny())
    b, m, n = 2, 7, 9
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((b, m), jnp.int32),
                            jnp.ones((b, n, 1), jnp.int32), jnp.ones((b, m, m), bool),
                            jnp.ones((b, n, m), bool), jnp.ones((b, n), bool))
    count = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    total, digest = param_count_fingerprint(model)
    assert total == count
    assert param_count_fingerprint(build_model(lina_gla_tiny(), device="cpu", seed=5)) == \
        (total, digest)  # the structure, not the values
    other = build_model(lina_gla_tiny(n_codebook=51), device="cpu")
    assert param_count_fingerprint(other)[1] != digest


# -------------------------------------------------------- the gloo world
def _model_pair(kind):
    """(port model with random weights, the JAX model and its params by the
    bridge): the tiny config, short convs on, RWKV6's and Mamba's constant
    inits moved off their constants."""
    model = build_model(tiny_cfg(kind, False), device="cpu", seed=0)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        if kind == "rwkv6":
            perturb_rwkv6_params_(model, gen)
        if kind == "mamba":
            perturb_mamba_params_(model, gen)
    jcfg = jax_tiny()
    extra = {"rwkv6": dict(kind="rwkv6"), "mamba": dict(kind="mamba"), "gla": {}}[kind]
    jm = jax_build(dataclasses.replace(
        jcfg, backbone=dataclasses.replace(jcfg.backbone, n_layer=1, use_short_conv=True,
                                           **extra),
        text_encoder=dataclasses.replace(jcfg.text_encoder, n_layers=1)))
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v)
         for k, v in named_tensors_to_jax(model.named_parameters()).items()})}
    return model, jm, params


def _fit_argv(steps, ckpt, log, *extra):
    return ["fit", "--config", TINY, "--device", "cpu", "--steps", str(steps),
            "--ckpt-dir", ckpt, "--log-file", log, "--log-every", "1", "--ckpt-every", "1000",
            *extra]


def _losses(log):
    with open(log) as fh:
        return {r["step"]: r["loss"] for r in map(json.loads, fh) if "loss" in r}


def _jax_step(kind, jm, params, batch):
    """(loss, top-10 accuracy, gradients by flax path) of the JAX package's
    single-device training forward and backward on the whole batch."""
    keys = ("text_token", "audio_token", "encoder_mask", "crossatt_mask")

    def loss_fn(p):
        logits, loss, _ = jm.apply(p, *(jnp.asarray(batch[k]) for k in keys),
                                   logits_mask=jnp.asarray(batch["y_mask"]))
        return loss, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    acc = jax_topk(logits[:, :, 0], jnp.asarray(batch["audio_token"][:, 1:, 0]),
                   mask=jnp.asarray(batch["y_mask"][:, 1:]))
    return float(loss), float(acc), traverse_util.flatten_dict(grads["params"], sep="/")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' results of every case, one world, and the references,
    computed here while the world runs."""
    tmp = tmp_path_factory.mktemp("parallel")
    batch = _batch(seed=5)  # ragged valid counts: lengths 9 to 26
    pairs = {kind: _model_pair(kind) for kind in KINDS}
    # fit: a dp 1 run of 2 steps (its checkpoint resumed at dp 2 x cp 2)
    d1, log1 = str(tmp / "dp1"), str(tmp / "dp1.jsonl")
    cli.main(_fit_argv(2, d1, log1))
    resume_here = str(tmp / "from_dp1")
    shutil.copytree(d1, resume_here)
    rng = np.random.default_rng(9)
    audio = (rng.normal(size=(2, 2048)) * 0.1).astype(np.float32)
    lat = rng.normal(size=(4, 6, 8)).astype(np.float32)
    embed = rng.uniform(-1, 1, size=(2, 16, 8)).astype(np.float32)
    cluster = rng.uniform(0, 4, size=(2, 16)).astype(np.float32)
    cases = {f"step-{kind}": ("train_step", (
        kind, {k: v.detach().numpy() for k, v in pairs[kind][0].state_dict().items()},
        batch, 2, 2)) for kind in KINDS}
    cases["fit"] = ("fit", (_fit_argv(2, str(tmp / "dp2"), str(tmp / "dp2.jsonl"),
                                      "--dp", "2", "--cp", "2"),))
    cases["fit-resumed"] = ("fit", (_fit_argv(3, resume_here, str(tmp / "resumed.jsonl"),
                                              "--dp", "2", "--cp", "2", "--resume"),))
    cases["gan"] = ("codec_gan_step", (audio, 2, 2))
    cases["vq"] = ("vq_update", (lat, embed, cluster, 2, 2))
    cases["replicated"] = ("replicated", (2,))
    running = World(4, cases)
    refs = {kind: _jax_step(kind, *pairs[kind][1:], batch) for kind in KINDS}
    gan = codec_gan_reference(torch.from_numpy(audio))
    return SimpleNamespace(tmp=tmp, batch=batch, refs=refs, gan=gan, lat=lat,
                           embed=embed, cluster=cluster, results=running.results(), log1=log1)


@pytest.mark.parametrize("kind", KINDS)
def test_dp2_cp2_train_step_matches_the_jax_single_device_step(world, kind):
    loss, acc, ref = world.refs[kind]
    valid = world.batch["y_mask"][:, 1:].sum(1)
    assert len(set(valid.tolist())) > 1  # ragged: the ranks hold different counts
    for rank, res in enumerate(world.results):
        res = res[f"step-{kind}"]
        np.testing.assert_allclose(res["metrics"]["loss"], loss, rtol=TOL_METRIC)
        np.testing.assert_allclose(res["metrics"]["acc_0"], acc, rtol=TOL_METRIC)
        got = named_tensors_to_jax({k: torch.from_numpy(v) for k, v in res["grads"].items()})
        assert set(got) == set(ref)
        for path, r in ref.items():
            r = np.asarray(r, np.float32)
            err = float(np.abs(got[path] - r).max())
            # + 1e-7: the key-side biases of the softmax attentions have a
            # gradient that is zero in exact arithmetic; both sides hold
            # rounding noise there
            assert err <= TOL_GRAD * float(np.abs(r).max()) + 1e-7, (rank, path, err)


def test_fit_dp2_cp2_equals_dp1_and_resumes_across_layouts(world):
    """fit at dp 2 x cp 2 logs the losses the single process logs; a dp 1
    checkpoint resumed there and theirs resumed at dp 1 take the same step;
    its keys are the model's own."""
    tmp = world.tmp
    assert [r["fit"] for r in world.results] == [2] * 4
    assert [r["fit-resumed"] for r in world.results] == [3] * 4
    dp1, dp2 = _losses(world.log1), _losses(str(tmp / "dp2.jsonl"))
    assert sorted(dp1) == sorted(dp2) == [0, 1]
    for step in dp1:
        np.testing.assert_allclose(dp2[step], dp1[step], rtol=TOL_METRIC)
    # a resumed run restarts its data, so step 2 of a resumed run is the
    # first batch again, from the state after two steps: dp 1's checkpoint
    # resumed at dp 2 x cp 2 (in the world) and dp 2 x cp 2's at dp 1 take
    # the same step
    back = str(tmp / "from_dp2")
    shutil.copytree(str(tmp / "dp2"), back)
    cli.main(_fit_argv(3, back, str(tmp / "back.jsonl"), "--resume"))
    resumed, back = _losses(str(tmp / "resumed.jsonl")), _losses(str(tmp / "back.jsonl"))
    assert sorted(resumed) == sorted(back) == [2]
    np.testing.assert_allclose(back[2], resumed[2], rtol=TOL_METRIC)
    assert abs(back[2] - dp1[0]) > 1e-3  # it is not the first step's loss
    saved = restore_checkpoint(latest_checkpoint(str(tmp / "dp2")))
    assert set(saved["model"]) == set(build_model(lina_gla_tiny(), device="cpu").state_dict())


def test_codec_gan_step_dp2_matches_the_whole_batch(world):
    """Both optimizers' gradients (averaged over the two ranks of a dp line)
    against one process's on the whole batch, each within 3e-4 of its own
    max|ref|, floored at 1e-6 of its optimizer's largest gradient: the
    biases ahead of the GroupNorms get gradients near 1e-7 against a
    largest of about 8 (a loss of about 61), where f32 rounding is all
    there is."""
    ref = world.gan
    largest = {tag: max(float(np.abs(r).max()) for n, r in ref["grads"].items()
                        if n.startswith(tag)) for tag in ("gen:", "disc:")}
    for rank, res in enumerate(world.results):
        res = res["gan"]
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=TOL_METRIC, err_msg=k)
        assert set(res["grads"]) == set(ref["grads"])
        for name, r in ref["grads"].items():
            err = float(np.abs(res["grads"][name] - r).max())
            floor = 1e-6 * largest[name.split(":")[0] + ":"]
            assert err <= max(TOL_GRAD * float(np.abs(r).max()), floor), (rank, name, err)


def test_vq_ema_update_and_expiry_dp2(world):
    """The counts and embedding sums summed over dp: the whole batch's
    update; the expiry draws the same rows on both ranks of a dp line, from
    the mean of their batches."""
    q = tvq.VQState(embed=torch.from_numpy(world.embed),
                    cluster_size=torch.from_numpy(world.cluster),
                    embed_avg=torch.from_numpy(world.embed).clone())
    whole = tvq.vq_train_step(torch.from_numpy(world.lat), q, n_q=2).quantizer
    mean = torch.from_numpy((world.lat[:2] + world.lat[2:]) / 2)
    expired = tvq.expire_dead_codes(torch.Generator().manual_seed(1), q, mean)
    for res in world.results:
        res = res["vq"]
        for f in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(res[f], getattr(whole, f).numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["expired"], expired.embed.numpy(), rtol=1e-6, atol=1e-6)
    assert int((q.cluster_size < 2.0).sum()) > 0  # some codes were dead


def test_assert_replicated_passes_then_names_the_perturbed_parameter(world):
    for res in world.results:
        msg = res["replicated"]
        assert msg is not None and "attentive_rnn.decoder.1.cmix.p_out.weight" in msg
        assert "group ranks 0 and 2" in msg
