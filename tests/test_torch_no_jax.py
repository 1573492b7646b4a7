"""The PyTorch port imports neither jax nor flax.

A fresh interpreter blocks both (``sys.modules[name] = None`` makes any
import of them fail), imports every module of the port and runs a tiny
``generate_batch``; it then checks that no jax/flax module was loaded.
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
