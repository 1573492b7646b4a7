"""The port's training CLI, checkpoints and profiling helpers on the CPU,
against the JAX package where it has a counterpart (tiny config).

``build_data`` (both kinds) and ``load_config`` (every YAML config) equal
the JAX package's array by array and field for field. ``fit`` warm-started
from JAX params (carried in by ``utils/convert.py:load_jax_params`` and
saved as a port checkpoint) logs per-step losses within 1e-4 relative of
JAX's ``make_train_step`` on the same batches, the tolerance of
``test_torch_train.py::test_three_train_steps_match_jax``. A checkpoint
restores bit for bit (parameters, both Adam moments, the step), and a step
from the restored state equals, bit for bit, the same step from the saved
one; ``--resume`` continues from the latest ``step_<n>``.
"""
import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from lina_speech_tpu import config as jconfig
from lina_speech_tpu.data.dataset import TokenizedTTSDataset as JaxDataset
from lina_speech_tpu.train import cli as jcli
from lina_speech_tpu.train import harness as jharness
from lina_speech_tpu.utils.checkpoint import average_checkpoints as jax_average
from lina_speech_tpu.utils.profiling import MetricsLogger as JaxLogger
from lina_speech_tpu_torch import config as tconfig
from lina_speech_tpu_torch.data.dataset import TokenizedTTSDataset
from lina_speech_tpu_torch.train import cli
from lina_speech_tpu_torch.train.harness import batch_to_device, create_train_state, make_train_step
from lina_speech_tpu_torch.utils import checkpoint as ckpt
from lina_speech_tpu_torch.utils.convert import load_jax_params
from lina_speech_tpu_torch.utils.profiling import MetricsLogger, StepTimer, annotate, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "lina_gla_tiny.yaml")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_batches_equal(ours, theirs, n):
    for i in range(n):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys(), i
        for k in a:
            assert a[k].dtype == b[k].dtype, (i, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"batch {i} {k}")


def _items(seed, n, n_quant=1):
    rng = np.random.default_rng(seed)
    return [{"audio_token": rng.integers(0, 50, (n_quant, int(rng.integers(5, 40)))),
             "text": " ".join(["ab", "cde", "f"][: 1 + i % 3]) * (1 + i % 2)}
            for i in range(n)]


# ------------------------------------------------------------- build_data
@pytest.mark.parametrize("data_cfg", [
    dict(), dict(kind="synthetic", batch_size=3, min_audio_len=5, max_audio_len=30, seed=4),
    dict(kind="synthetic", batch_size=2, structured=True, min_audio_len=16, max_audio_len=32),
], ids=["defaults", "plain", "structured"])
def test_build_data_synthetic_equals_the_jax_package(data_cfg):
    ours = cli.build_data(data_cfg, tconfig.lina_gla_tiny())
    theirs = jcli.build_data(data_cfg, jconfig.lina_gla_tiny())
    _assert_batches_equal(ours, theirs, 3)


@pytest.mark.parametrize("n_quant,max_tokens,batch_size", [(1, 60, 3), (2, 8192, 4)])
def test_build_data_npz_equals_the_jax_package(tmp_path, n_quant, max_tokens, batch_size):
    """Shards written by the port's ``save_npz``; more batches than an
    epoch holds, so the per-epoch reseed is crossed."""
    paths = []
    for s in range(2):
        paths.append(str(tmp_path / f"shard_{s}.npz"))
        TokenizedTTSDataset.save_npz(paths[-1], _items(s, 7, n_quant))
    data_cfg = dict(kind="npz", npz_paths=paths, batch_size=batch_size, max_tokens=max_tokens,
                    seed=3)
    qs = tuple(range(n_quant))
    ours = cli.build_data(data_cfg, tconfig.lina_gla_tiny(quant_layer=qs))
    theirs = jcli.build_data(data_cfg, jconfig.lina_gla_tiny(quant_layer=qs))
    _assert_batches_equal(ours, theirs, 12)


def test_build_data_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown data kind"):
        cli.build_data({"kind": "parquet"}, tconfig.lina_gla_tiny())


# ------------------------------------------------------------- load_config
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_equals_the_jax_package(path):
    ours, theirs = tconfig.load_config(path), jconfig.load_config(path)
    assert ours.keys() == theirs.keys() == {"model", "train", "data"}
    assert type(ours["train"]).__name__ == "TrainConfig"
    for key in ("model", "train"):
        assert dataclasses.asdict(ours[key]) == dataclasses.asdict(theirs[key]), key
    assert ours["data"] == theirs["data"]
    assert ours["model"].n_quant == theirs["model"].n_quant


# ---------------------------------------------------------- fit vs JAX
def _jax_tiny():
    """The tiny YAML's JAX model, its params initialized as JAX's ``fit``
    does (PRNGKey(0) on the first batch), its train config and batches."""
    cfg = jconfig.load_config(TINY)
    jm = jconfig.build_model(cfg["model"])
    data = jcli.build_data(cfg["data"], cfg["model"])
    b0 = next(data)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), b0["text_token"], b0["audio_token"],
                              b0["encoder_mask"], b0["crossatt_mask"], b0["y_mask"])
    return jm, params, cfg, b0, data


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_fit_warm_started_from_jax_params_logs_the_jax_losses(tmp_path):
    jm, params, cfg, b0, data = _jax_tiny()
    model = load_jax_params(tconfig.build_model(tconfig.load_config(TINY)["model"],
                                                device="cpu"), params)
    weights = ckpt.save_checkpoint(str(tmp_path / "jax_weights"), {"model": model.state_dict()})
    log = str(tmp_path / "log.jsonl")
    state = cli.main(["fit", "--config", TINY, "--steps", "3", "--device", "cpu",
                      "--load-weights", weights, "--log-every", "1", "--log-file", log])
    assert state.step == 3
    got = _records(log)
    assert [r["step"] for r in got] == [0, 1, 2]

    jstate = jharness.create_train_state(
        jm, params, dataclasses.replace(cfg["train"], n_training_steps=3))
    jstep = jharness.make_train_step(jm, donate=False)
    rng = jax.random.PRNGKey(1)
    for i in range(3):
        jstate, jmet = jstep(jstate, b0 if i == 0 else next(data), rng)
        for k in ("loss", "grad_norm", "acc_0"):
            np.testing.assert_allclose(got[i][k], float(jmet[k]), rtol=1e-4, err_msg=f"{k} {i}")
        assert got[i]["step_time_s"] > 0


# ------------------------------------------------------------- checkpoints
def _tiny_state(seed=0):
    model = tconfig.build_model(tconfig.load_config(TINY)["model"], device="cpu", seed=seed)
    return create_train_state(model, tconfig.load_config(TINY)["train"])


def _batches():
    cfg = tconfig.load_config(TINY)
    return cli.build_data(cfg["data"], cfg["model"])


def _opt_tensors(opt):
    """Every tensor of an optimizer's state, in parameter order."""
    return [(i, k, v) for i, st in sorted(opt.state_dict()["state"].items())
            for k, v in sorted(st.items())]


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (n, p), (m, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert n == m and torch.equal(p, q), n
    ta, tb = _opt_tensors(a.optimizer), _opt_tensors(b.optimizer)
    assert len(ta) == len(tb) == 3 * len(list(a.model.parameters()))
    for (i, k, v), (j, l, w) in zip(ta, tb):
        assert (i, k) == (j, l) and torch.equal(v, w), (i, k)


def test_checkpoint_restores_bit_for_bit_and_the_next_step_agrees(tmp_path):
    state, data = _tiny_state(), _batches()
    step = make_train_step(state.model)
    for i in range(2):
        state, _ = step(state, batch_to_device(next(data), "cpu"), cli.step_generator(0, i, "cpu"))
    path = ckpt.save_checkpoint(str(tmp_path), {
        "model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
        "step": state.step}, step=state.step)
    assert os.path.basename(path) == "step_2"

    restored = _tiny_state(seed=5)  # other weights: all must come from the file
    full = ckpt.restore_checkpoint(path, map_location="cpu")
    restored.model.load_state_dict(full["model"])
    restored.optimizer.load_state_dict(full["optimizer"])
    restored.step = full["step"]
    _assert_states_equal(state, restored)

    batch = batch_to_device(next(data), "cpu")
    state, m1 = step(state, batch, cli.step_generator(0, 2, "cpu"))
    restored, m2 = make_train_step(restored.model)(restored, batch,
                                                   cli.step_generator(0, 2, "cpu"))
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_states_equal(state, restored)


def test_resume_continues_from_the_latest_checkpoint(tmp_path, capsys):
    """Three steps with a checkpoint every step (step_2, then step_3 twice),
    then ``--resume --steps 4``: it starts at step 3, writes step_4, and its
    state is the step-3 state advanced by one train step on the resumed
    run's batch (the second of a restarted iterator) with step 3's
    generator."""
    d = str(tmp_path / "ck")
    args = ["fit", "--config", TINY, "--device", "cpu", "--ckpt-dir", d, "--log-every", "1"]
    cli.main(args + ["--steps", "3", "--ckpt-every", "1"])
    assert ckpt.checkpoint_steps(d) == [2, 3]
    assert open(os.path.join(d, "config.yaml")).read() == open(TINY).read()
    capsys.readouterr()
    resumed = cli.main(args + ["--steps", "4", "--resume"])
    out = capsys.readouterr().out
    assert "resuming from step 3" in out and "[step 3]" in out and "[step 2]" not in out
    assert resumed.step == 4 and ckpt.checkpoint_steps(d) == [2, 3, 4]
    assert ckpt.latest_checkpoint(d).endswith("step_4")

    ref = _tiny_state(seed=5)
    full = ckpt.restore_checkpoint(os.path.join(d, "step_3"))
    ref.model.load_state_dict(full["model"])
    ref.optimizer.load_state_dict(full["optimizer"])
    ref.step = full["step"]
    data = _batches()
    next(data)
    ref, _ = make_train_step(ref.model)(ref, batch_to_device(next(data), "cpu"),
                                        cli.step_generator(0, 3, "cpu"))
    _assert_states_equal(resumed, ref)
    saved = ckpt.restore_checkpoint(os.path.join(d, "step_4"))
    assert saved["step"] == 4
    for n, p in ref.model.named_parameters():
        assert torch.equal(saved["model"][n], p), n


def test_save_replaces_atomically_and_only_finished_checkpoints_count(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, {"x": torch.zeros(3)}, step=5)
    ckpt.save_checkpoint(d, {"x": torch.ones(3)}, step=5)
    assert torch.equal(ckpt.restore_checkpoint(os.path.join(d, "step_5"))["x"], torch.ones(3))
    os.makedirs(os.path.join(d, "step_9"))  # a directory without a state file
    os.makedirs(os.path.join(d, ".tmp_step_12_1"))  # a save killed half way
    assert ckpt.checkpoint_steps(d) == [5]
    assert sorted(os.listdir(d)) == [".tmp_step_12_1", "step_5", "step_9"]
    assert ckpt.checkpoint_steps(str(tmp_path / "none")) == []
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_average_checkpoints_equals_the_jax_package():
    rng = np.random.default_rng(0)
    trees = [{"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)} for _ in range(3)]
    ours = ckpt.average_checkpoints([{k: torch.from_numpy(v) for k, v in t.items()}
                                     for t in trees])
    theirs = jax_average(trees)
    for k in trees[0]:
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
    with pytest.raises(ValueError):
        ckpt.average_checkpoints([])


# -------------------------------------------------------- what still raises
@pytest.mark.parametrize("flag", [["--dp", "2"], ["--tp", "2"], ["--cp", "4"],
                                  ["--coordinator", "localhost:1234"]], ids=str)
def test_multi_gpu_flags_raise_naming_item_11(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11"):
        cli.main(["fit", "--config", TINY, "--device", "cpu", "--steps", "1", *flag])


def test_fit_takes_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["fit", "--config", TINY, "--steps", "1"])


# ---------------------------------------------------------------- profiling
def test_metrics_logger_and_step_timer_equal_the_jax_package(tmp_path, capsys):
    recs = [(0, {"loss": 2.5, "grad_norm": np.float32(1.25)}), (3, {"loss": 1.0}),
            (4, {"val_loss": 0.5})]
    outs = {}
    for name, cls in (("ours", MetricsLogger), ("theirs", JaxLogger)):
        path = str(tmp_path / f"{name}.jsonl")
        logger = cls(path, print_every=2)
        for step, m in recs:
            logger.log(step, m)
        logger.close()
        outs[name] = (open(path).read(), capsys.readouterr().out)
    assert outs["ours"] == outs["theirs"]
    from lina_speech_tpu.utils.profiling import StepTimer as JaxTimer

    ours, theirs = StepTimer(warmup=1), JaxTimer(warmup=1)
    for dt in (5.0, 0.25, 0.5):
        ours.record(dt)
        theirs.record(dt)
    assert ours.mean == theirs.mean == 0.375 and ours.last == 0.5


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("lina_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "lina_step" for e in prof.key_averages())
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "lina_step" for e in events)


def test_npz_shards_cross_between_the_packages(tmp_path):
    items = _items(9, 5, n_quant=2)
    TokenizedTTSDataset.save_npz(str(tmp_path / "ours.npz"), items)
    JaxDataset.save_npz(str(tmp_path / "theirs.npz"), items)
    for path in ("ours.npz", "theirs.npz"):
        a = TokenizedTTSDataset(npz_paths=[str(tmp_path / path)])
        b = JaxDataset(npz_paths=[str(tmp_path / path)])
        assert len(a) == len(b) == 5
        np.testing.assert_array_equal(a.lengths(), b.lengths())
        for x, y in zip(a.items, b.items):
            assert x["text"] == y["text"]
            np.testing.assert_array_equal(x["audio_token"], y["audio_token"])
