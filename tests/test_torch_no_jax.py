"""The PyTorch port imports neither jax nor flax.

A fresh interpreter blocks both (``sys.modules[name] = None`` makes any
import of them fail), imports every module of the port (``train/``,
``data/`` and ``models/accuracy.py`` among them), runs a tiny
``generate_batch``, a server, one train step, one S0 tuning step and
``examples/train_torch.py``; it then checks that no jax/flax module and
nothing of ``lina_speech_tpu`` was loaded.
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
