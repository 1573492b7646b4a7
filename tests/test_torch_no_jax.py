"""The PyTorch port imports neither jax nor flax.

A fresh interpreter blocks both (``sys.modules[name] = None`` makes any
import of them fail), imports every module of the port (``train/``,
``data/`` and ``models/accuracy.py`` among them), runs a tiny
``generate_batch``, a server (both also with int8 weights and int8
lazy-window states: ``utils/quantize.py``, ``ops/qlinear.py``), one train
step, one S0 tuning step, ``examples/train_torch.py``, and a generate and a
train step of the simple-GLA (no convs), Mamba-2 and RWKV6 backbones
(``models/simple_gla.py``, ``models/mamba.py``, ``models/rwkv6.py`` with
``ops/rwkv6.py`` and ``ops/rwkv6_cuda.py``); it then checks that no
jax/flax module and nothing of ``lina_speech_tpu`` was loaded.
"""
import os
import subprocess
import sys

SCRIPT = r"""
import importlib, pkgutil, sys
pre = {m for m in sys.modules if m.split(".")[0] in ("jax", "flax")}
if not pre:
    sys.modules["jax"] = None
    sys.modules["flax"] = None
import torch
torch.set_num_threads(1)
import lina_speech_tpu_torch
for info in pkgutil.walk_packages(lina_speech_tpu_torch.__path__, "lina_speech_tpu_torch."):
    importlib.import_module(info.name)
from lina_speech_tpu_torch.config import build_model, lina_gla_tiny
from lina_speech_tpu_torch.generate import generate_batch
model = build_model(lina_gla_tiny(), device="cpu")
res = generate_batch(model, torch.randint(3, 256, (2, 5)), torch.Generator().manual_seed(0),
                     prompt=torch.randint(0, 50, (1, 2, 3)), max_seqlen=8, k=5,
                     force_max_seqlen=True)
assert res.tokens.shape == (1, 2, 8)
from lina_speech_tpu_torch.serving import DecodeServer
srv = DecodeServer(model, n_slots=1, max_text_len=8, chunk=4, lazy=True)
for n in (3, 5):
    srv.submit(list(range(3, 3 + n)), prompt=[[7, 8, 9]], max_len=10)
assert sorted(c.length for c in srv.run()) == [10, 10]
# the quantized serving path: int8 weights and int8 lazy-window states
for name in ("lina_speech_tpu_torch.utils.quantize", "lina_speech_tpu_torch.ops.qlinear"):
    assert name in sys.modules, name
quant = dict(weight_quant="int8", quant_min_size=256, state_quant="int8")
res = generate_batch(model, torch.randint(3, 256, (2, 5)), max_seqlen=9, k=1,
                     force_max_seqlen=True, lazy_window=4, **quant)
assert res.tokens.shape == (1, 2, 9) and model.logits_head.int8_q.dtype == torch.int8
srv = DecodeServer(model, n_slots=2, max_text_len=8, chunk=4, lazy=True, **quant)
for n in (3, 5, 4):
    srv.submit(list(range(3, 3 + n)), prompt=[[7, 8, 9]], max_len=10)
assert len(srv.run()) == 3 and srv._state.layers[0].s.dtype == torch.int8
# the training path: data, one train step, one S0 tuning step, the example
from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
from lina_speech_tpu_torch.train.harness import (
    TrainConfig, batch_to_device, create_train_state, make_train_step)
from lina_speech_tpu_torch.train.initial_state import (
    InitialStateTuningConfig, train_initial_state)
batch = batch_to_device(next(synthetic_tts_batches(
    batch_size=2, n_codebook=50, min_audio_len=8, max_audio_len=8, pad_to_multiple=8)), "cpu")
state = create_train_state(model, TrainConfig(n_warmup_steps=1, n_training_steps=4))
state, metrics = make_train_step(model)(state, batch)
assert state.step == 1 and float(metrics["grad_norm"]) > 0
_, losses = train_initial_state(model, [batch], InitialStateTuningConfig(grad_acc=1))
assert len(losses) == 1
import importlib.util
spec = importlib.util.spec_from_file_location("train_torch", "examples/train_torch.py")
example = importlib.util.module_from_spec(spec)
spec.loader.exec_module(example)
sys.argv = ["train_torch.py", "--cpu", "--steps", "1", "--batch", "2", "--min-len", "8",
            "--max-len", "8"]
example.main()
# the other backbones: simple-GLA without convs, Mamba-2 and RWKV6
import dataclasses
for name in ("lina_speech_tpu_torch.models.simple_gla", "lina_speech_tpu_torch.models.mamba",
             "lina_speech_tpu_torch.models.rwkv6", "lina_speech_tpu_torch.ops.rwkv6_cuda"):
    assert name in sys.modules, name
for kw in (dict(kind="simple_gla", use_short_conv=False), dict(kind="mamba2"),
           dict(kind="rwkv6")):
    cfg = lina_gla_tiny()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, **kw))
    variant = build_model(cfg, device="cpu")
    res = generate_batch(variant, torch.randint(3, 256, (2, 5)), max_seqlen=7, k=1,
                         force_max_seqlen=True)
    assert res.tokens.shape == (1, 2, 7)
    state = create_train_state(variant, TrainConfig(n_warmup_steps=1, n_training_steps=4))
    state, metrics = make_train_step(variant)(state, batch)
    assert state.step == 1 and float(metrics["grad_norm"]) > 0
assert not any(m.split(".")[0] == "lina_speech_tpu" for m in sys.modules)
post = {m for m in sys.modules
        if m.split(".")[0] in ("jax", "flax") and sys.modules[m] is not None}
assert post == pre, sorted(post - pre)
print("OK")
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_sources_import_no_jax():
    """Every module of the port (``utils/quantize.py``, ``ops/qlinear.py``,
    ``models/mamba.py``, ``models/simple_gla.py`` and the RWKV6 modules
    among them),
    ``chip_smoke.py`` and the port's examples, read as source:
    no import statement names jax, flax or the JAX package."""
    import ast
    import glob

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = glob.glob(os.path.join(root, "lina_speech_tpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(root, "chip_smoke.py")]
    files += glob.glob(os.path.join(root, "examples", "*_torch.py"))
    names = {os.path.relpath(f, root) for f in files}
    for must in ("lina_speech_tpu_torch/utils/quantize.py", "lina_speech_tpu_torch/ops/qlinear.py",
                 "lina_speech_tpu_torch/models/mamba.py",
                 "lina_speech_tpu_torch/models/simple_gla.py",
                 "lina_speech_tpu_torch/models/rwkv6.py", "lina_speech_tpu_torch/ops/rwkv6.py",
                 "lina_speech_tpu_torch/ops/rwkv6_cuda.py",
                 "chip_smoke.py", "examples/serve_torch.py"):
        assert must in names, must
    banned = ("jax", "flax", "lina_speech_tpu")
    for path in files:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for mod in mods:
                assert mod.split(".")[0] not in banned, (os.path.relpath(path, root), mod)
