"""The PyTorch port imports neither jax nor flax.

A fresh interpreter blocks both (a finder at the head of ``sys.meta_path``
makes any import of them fail; scipy, which the resampler imports, probes
``sys.modules`` for jax and so needs the names absent, not set to None), imports every module of the port (``train/``,
``data/`` and ``models/accuracy.py`` among them), runs a tiny
``generate_batch``, a server (both also with int8 weights and int8
lazy-window states: ``utils/quantize.py``, ``ops/qlinear.py``, and with
int4 states), one step of codec GAN training through
``train/codec_cli.py`` (``codec/losses.py``, ``discriminators.py``,
``gan.py``, ``metrics.py``), one train
step, one S0 tuning step, ``examples/train_torch.py``, and a generate and a
train step of the simple-GLA (no convs), Mamba-2, RWKV6 and Mamba (v1,
blind and interleaved) backbones and of the softmax transformer with a
speaker encoder (``models/transformer.py``, ``SimpleSpeakerEncoder`` in
``models/encoder.py``; its generate with a prompt and classifier-free
guidance, and a guided server on the GLA model) (``models/simple_gla.py``,
``models/mamba.py`` with ``AttentiveMamba``, ``CrossAttMamba``,
``ops/mamba.py`` and ``ops/mamba_cuda.py``, ``models/rwkv6.py`` with
``ops/rwkv6.py`` and ``ops/rwkv6_cuda.py``), and the TTS pipeline on a tiny
codec (``codec/``, ``pipeline.py``: ``tokenize_audio``, ``synthesize``
with a prompt, ``stream_synthesize``), the compression stack (a tiny
``compress_audio`` -> ``decompress_audio`` round trip on the native coder:
``codec/encodec.py``, ``codec/lm.py``, ``codec/streaming_transformer.py``,
``codec/ac.py`` with ``native/ac.cpp``), ``quantize_params`` and
``RotaryEmbedding``, and the training entry point: a tiny
``train.cli fit`` with ``remat`` on npz shards made by
``scripts/prepare_dataset_torch.py`` from WAV files (``data/dataset.py``,
``data/audio_loader.py``, ``data/resample.py``), saving, resuming and
restoring a checkpoint (``utils/checkpoint.py``), the native audio loader
and a profiler trace (``utils/profiling.py``); it then checks that no
jax/flax module and nothing of ``lina_speech_tpu`` was loaded.
"""
import os
import subprocess
import sys

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys
pre = {m for m in sys.modules if m.split(".")[0] in ("jax", "flax")}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "flax"):
            raise ImportError(f"{name} is blocked")


if not pre:
    sys.meta_path.insert(0, Block())
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
# int4 lazy-window states, generate and server
res = generate_batch(model, torch.randint(3, 256, (2, 5)), max_seqlen=9, k=1,
                     force_max_seqlen=True, lazy_window=4, state_quant="int4")
assert res.tokens.shape == (1, 2, 9)
srv = DecodeServer(model, n_slots=2, max_text_len=8, chunk=4, lazy=True, state_quant="int4")
srv.submit([3, 4, 5], prompt=[[7, 8, 9]], max_len=10)
assert len(srv.run()) == 1
st = srv._state.layers[0]
assert st.s.dtype == torch.int8 and 2 * st.s.shape[-1] == st.vbuf.shape[-1]
# codec GAN training: one step of the tiny codec through the CLI
from lina_speech_tpu_torch.train import codec_cli
gan = codec_cli.main(["fit", "--device", "cpu", "--tiny", "--steps", "1", "--crop-len", "2048",
                      "--log-every", "1"])
assert gan.step == 1 and gan.disc_step == 1
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
# the other backbones: simple-GLA without convs, Mamba-2, RWKV6 and Mamba (v1)
import dataclasses
for name in ("lina_speech_tpu_torch.models.simple_gla", "lina_speech_tpu_torch.models.mamba",
             "lina_speech_tpu_torch.models.rwkv6", "lina_speech_tpu_torch.ops.rwkv6_cuda",
             "lina_speech_tpu_torch.ops.mamba", "lina_speech_tpu_torch.ops.mamba_cuda"):
    assert name in sys.modules, name
from lina_speech_tpu_torch.models.mamba import AttentiveMamba, CrossAttMamba
for kw, cls in ((dict(kind="simple_gla", use_short_conv=False), None),
                (dict(kind="mamba2"), None), (dict(kind="rwkv6"), None),
                (dict(kind="mamba"), AttentiveMamba),
                (dict(kind="mamba", cross_att_layers=(1,), blind=False), CrossAttMamba)):
    cfg = lina_gla_tiny()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, **kw))
    variant = build_model(cfg, device="cpu")
    assert cls is None or isinstance(variant.attentive_rnn, cls)
    res = generate_batch(variant, torch.randint(3, 256, (2, 5)), max_seqlen=7, k=1,
                         force_max_seqlen=True)
    assert res.tokens.shape == (1, 2, 7)
    state = create_train_state(variant, TrainConfig(n_warmup_steps=1, n_training_steps=4))
    state, metrics = make_train_step(variant)(state, batch)
    assert state.step == 1 and float(metrics["grad_norm"]) > 0
# the softmax transformer with a speaker encoder, and classifier-free guidance
from lina_speech_tpu_torch.config import SpeakerEncoderConfig
from lina_speech_tpu_torch.models.transformer import TransformerCrossAtt
cfg = lina_gla_tiny(mask_text_p=0.1, spk_encoder=SpeakerEncoderConfig(
    dim_inner=32, heads=2, n_layers=1, window_length=4))
cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, kind="transformer"))
variant = build_model(cfg, device="cpu")
assert isinstance(variant.attentive_rnn, TransformerCrossAtt)
res = generate_batch(variant, torch.randint(3, 256, (2, 5)), prompt=torch.randint(0, 50, (1, 2, 6)),
                     max_seqlen=10, k=1, force_max_seqlen=True, cfg_coef=2.0)
assert res.tokens.shape == (1, 2, 10)
state = create_train_state(variant, TrainConfig(n_warmup_steps=1, n_training_steps=4))
state, metrics = make_train_step(variant)(state, batch, torch.Generator().manual_seed(0))
assert state.step == 1 and float(metrics["grad_norm"]) > 0
srv = DecodeServer(build_model(lina_gla_tiny(mask_text_p=0.1), device="cpu"), n_slots=2,
                   max_text_len=8, chunk=4, cfg_coef=2.0)
for n in (3, 5, 4):
    srv.submit(list(range(3, 3 + n)), prompt=[[7, 8, 9]], max_len=10)
assert len(srv.run()) == 3 and srv._x_enc.shape[0] == 4
# the TTS pipeline: the codec's encoder for a prompt, synthesis, streaming
from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig, build_wavtokenizer
from lina_speech_tpu_torch.data.tokenizer import TextTokenizer
from lina_speech_tpu_torch.pipeline import TTSPipeline
wavtok = build_wavtokenizer(WavTokenizerConfig(
    ratios=(4, 2), n_filters=2, latent_dim=16, bins=32, backbone_dim=32,
    backbone_intermediate_dim=64, backbone_layers=1, n_fft=16, hop_length=8), device="cpu")
pipe = TTSPipeline(build_model(lina_gla_tiny(n_codebook=32), device="cpu"), wavtok,
                   TextTokenizer())
codes = pipe.tokenize_audio(torch.randn(1, 40))
assert codes.shape == (1, 1, 5)
waves, res = pipe.synthesize("hi", prompt_codes=codes, max_seqlen=12, k=1)
assert waves[0].ndim == 1 and res.tokens.shape == (1, 1, 12)
assert sum(c.shape[-1] for c in pipe.stream_synthesize(
    "hi", max_seqlen=12, k=1, window=4, context=2, chunk=4)) % 8 == 0
# the compression stack: segmented EnCodec, the LM and the native arithmetic coder
from lina_speech_tpu_torch.codec import ac
from lina_speech_tpu_torch.codec.encodec import (
    build_encodec_model, compress_audio, decode_segmented, decompress_audio, encode_segmented)
from lina_speech_tpu_torch.codec.lm import build_encodec_lm
codec = build_encodec_model(device="cpu", dimension=16, n_filters=2, ratios=(4, 2), n_q=2,
                            bins=17, residual=True)
clm = build_encodec_lm(2, 17, device="cpu", dim=32, heads=4, n_layers=1, past_context=8)
audio = torch.randn(1, 300)
blob = compress_audio(codec, clm, audio, 160, 0.01, normalize=True)
assert isinstance(ac.make_coder(), ac.NativeArithmeticCoder)
want = decode_segmented(codec, encode_segmented(codec, audio, 160, 0.01, True), 160, 0.01,
                        True)[..., :300]
assert torch.equal(decompress_audio(codec, clm, blob), want)
from lina_speech_tpu_torch.ops import RotaryEmbedding
from lina_speech_tpu_torch.utils.quantize import quantize_params
assert RotaryEmbedding(8)(torch.randn(1, 2, 5, 16), 7).shape == (1, 2, 5, 16)
assert "int8_q" in quantize_params(dict(model.named_parameters()), 1 << 10)["logits_head.weight"]
# the training entry point on real-data shards: WAVs -> prepare_dataset_torch -> fit
import os, tempfile, wave
import numpy as np
from lina_speech_tpu_torch.data.audio_loader import make_audio_loader
from lina_speech_tpu_torch.train import cli
from lina_speech_tpu_torch.utils.checkpoint import checkpoint_steps, restore_checkpoint
from lina_speech_tpu_torch.utils.profiling import trace
tmp = tempfile.mkdtemp()
rng = np.random.default_rng(0)
lines = []
for i, name in enumerate(("a.wav", "b@16000.wav", "c.wav")):
    with wave.open(os.path.join(tmp, name), "wb") as w:
        w.setnchannels(1); w.setsampwidth(2); w.setframerate(24000)
        w.writeframes((0.2 * rng.normal(size=100 + 30 * i) * 32767).astype("<i2").tobytes())
    lines.append(f"{os.path.join(tmp, name)}\tword {i}\n")
open(os.path.join(tmp, "m.tsv"), "w").write("".join(lines))
with make_audio_loader([os.path.join(tmp, "a.wav")], 64, 2, n_threads=1) as loader:
    assert next(loader).shape == (2, 64)
spec = importlib.util.spec_from_file_location("prep", "scripts/prepare_dataset_torch.py")
prep = importlib.util.module_from_spec(spec)
spec.loader.exec_module(prep)
shards, n = prep.prepare(wavtok, os.path.join(tmp, "m.tsv"), os.path.join(tmp, "out"),
                         shard_size=2)
assert n == 3 and len(shards) == 2
open(os.path.join(tmp, "c.yaml"), "w").write(
    "model: {d_model: 64, n_codebook: 32, backbone: {d_model: 64, n_layer: 2, heads: 2, "
    "chunk_size: 16, pos_type: sinusoidal, remat: true, dropout: 0.1}, "
    "text_encoder: {dim: 64, heads: 2, n_layers: 2}}\n"
    "train: {n_warmup_steps: 1}\n"
    f"data: {{kind: npz, npz_paths: {shards}, batch_size: 2}}\n")
ck = os.path.join(tmp, "ck")
args = ["fit", "--config", os.path.join(tmp, "c.yaml"), "--device", "cpu", "--ckpt-dir", ck]
with trace(os.path.join(tmp, "trace")):
    state = cli.main(args + ["--steps", "1"])
assert os.path.exists(os.path.join(tmp, "trace", "trace.json"))
state = cli.main(args + ["--steps", "2", "--resume"])
assert state.step == 2 and checkpoint_steps(ck) == [1, 2]
assert restore_checkpoint(os.path.join(ck, "step_2"))["step"] == 2
assert state.model.attentive_rnn.remat
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
    the compression stack, ``utils/viz.py``, ``ops/rotary.py``,
    ``models/mamba.py``, ``models/simple_gla.py``, ``models/transformer.py``, the RWKV6 modules,
    ``ops/mamba.py``, ``ops/mamba_cuda.py``, ``utils/int8_timeline.py``,
    the codec and its GAN training, ``pipeline.py``, ``train/cli.py``,
    ``train/codec_cli.py``, ``utils/checkpoint.py``,
    ``utils/profiling.py`` and the real-data modules among them),
    ``chip_smoke.py``, the port's examples and
    ``scripts/prepare_dataset_torch.py``, read as source:
    no import statement names jax, flax or the JAX package."""
    import ast
    import glob

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = glob.glob(os.path.join(root, "lina_speech_tpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(root, "chip_smoke.py")]
    files += glob.glob(os.path.join(root, "examples", "*_torch.py"))
    files += [os.path.join(root, "scripts", "prepare_dataset_torch.py")]
    names = {os.path.relpath(f, root) for f in files}
    for must in ("lina_speech_tpu_torch/utils/quantize.py", "lina_speech_tpu_torch/ops/qlinear.py",
                 "lina_speech_tpu_torch/models/mamba.py",
                 "lina_speech_tpu_torch/models/simple_gla.py",
                 "lina_speech_tpu_torch/models/transformer.py",
                 "lina_speech_tpu_torch/models/encoder.py",
                 "lina_speech_tpu_torch/models/rwkv6.py", "lina_speech_tpu_torch/ops/rwkv6.py",
                 "lina_speech_tpu_torch/ops/rwkv6_cuda.py",
                 "lina_speech_tpu_torch/ops/mamba.py", "lina_speech_tpu_torch/ops/mamba_cuda.py",
                 "lina_speech_tpu_torch/utils/int8_timeline.py",
                 *(f"lina_speech_tpu_torch/codec/{m}.py" for m in (
                     "__init__", "spectral", "mdct", "heads", "vocos", "vq", "seanet",
                     "wavtokenizer", "losses", "discriminators", "gan", "metrics")),
                 *(f"lina_speech_tpu_torch/codec/{m}.py" for m in (
                     "ac", "encodec", "lm", "streaming_transformer")),
                 "lina_speech_tpu_torch/utils/viz.py", "lina_speech_tpu_torch/ops/rotary.py",
                 "lina_speech_tpu_torch/train/codec_cli.py",
                 "lina_speech_tpu_torch/pipeline.py", "examples/synthesize_torch.py",
                 "examples/stream_torch.py", "chip_smoke.py", "examples/serve_torch.py",
                 "lina_speech_tpu_torch/train/cli.py", "lina_speech_tpu_torch/utils/checkpoint.py",
                 "lina_speech_tpu_torch/utils/profiling.py",
                 *(f"lina_speech_tpu_torch/data/{m}.py" for m in (
                     "dataset", "audio_loader", "resample")),
                 "scripts/prepare_dataset_torch.py"):
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
