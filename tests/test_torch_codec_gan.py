"""Codec GAN training of the PyTorch port vs the JAX package, on the CPU.

``codec/losses.py``, ``codec/discriminators.py`` (through the weight bridge
``utils/convert.py:discriminator_state_dict_*``), the training half of
``codec/vq.py``, ``codec/gan.py``'s two steps, ``codec/metrics.py`` and
``train/codec_cli.py``. Inputs are numpy arrays from a seed; weights cross
through ``utils/convert.py``; random draws that ``jax.random`` makes are
injected into the port's functions.

Tolerances. One op or a short chain of f32 ops in another order: 1e-5. A
discriminator's scores and feature maps (six convs deep, up to 1024
channels, on an FFT): 1e-4 of their own max|ref|. One disc_step and one
gen_step from carried weights: the gradients (the first moments both
optimizers keep, (1 - b1) g) within 1e-4 of the network's largest, and the
updated parameters within 1e-4 of the leaf's max|ref|. A first Adam step
moves an element by lr g / (|g| + eps), about the learning rate (2e-4) in
the gradient's direction, so this holds the sign of every element's
gradient -- where the sign is resolved, that is where the two frameworks'
gradients agree to 10% (or are both exactly zero). The other elements are
held to the update's bound, 2 lr, and must be under 1% of the network: they
are f32 noise around a gradient that vanishes by construction -- biases in
front of a LayerNorm or of a GroupNorm of one channel a group, the
attention's key bias under the softmax (373 of the tiny generator's 40,249
elements, 53 of the MPD's 8,221,154, 1 of the MRD's 93,634). The
generator's GroupNorms (the Vocos pos_net) take torch's variance where flax
takes E[x^2] - E[x]^2 (tests/test_torch_codec.py); on these inputs that
moves nothing beyond the 1e-4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lina_speech_tpu.codec.gan as jgan
from lina_speech_tpu.codec import discriminators as jdisc
from lina_speech_tpu.codec import losses as jlosses
from lina_speech_tpu.codec import metrics as jmetrics
from lina_speech_tpu.codec import vq as jvq
from lina_speech_tpu.codec.wavtokenizer import WavTokenizer as JaxWavTokenizer
from lina_speech_tpu.codec.wavtokenizer import WavTokenizerConfig as JaxConfig
import lina_speech_tpu_torch.codec.gan as tgan
from lina_speech_tpu_torch.codec import discriminators as tdisc
from lina_speech_tpu_torch.codec import losses as tlosses
from lina_speech_tpu_torch.codec import metrics as tmetrics
from lina_speech_tpu_torch.codec import vq as tvq
from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig, build_wavtokenizer
from lina_speech_tpu_torch.train import codec_cli
from lina_speech_tpu_torch.utils import convert
from lina_speech_tpu_torch.utils.checkpoint import restore_checkpoint

TOL_OP, TOL_DEEP = 1e-5, 1e-4
TINY = dict(ratios=(4, 2), n_filters=2, latent_dim=16, bins=16, backbone_dim=32,
            backbone_intermediate_dim=48, backbone_layers=1, n_fft=16, hop_length=8)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def held(out, ref, tol, what=""):
    """max|out - ref| within ``tol`` of max|ref|."""
    out = np.asarray(out.detach() if torch.is_tensor(out) else out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(out).all(), what
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(out - ref).max()
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol} x {scale:.3e}"


def t(a):
    return torch.from_numpy(np.array(a))


def _audio(seed, b, n):
    return np.random.default_rng(seed).normal(size=(b, n)).astype(np.float32) * 0.3


# ------------------------------------------------------------- losses.py
def test_mel_filterbank_and_stft_match_jax():
    for args in ((24000, 1024, 100), (16000, 512, 40), (24000, 128, 16)):
        np.testing.assert_array_equal(tlosses.mel_filterbank(*args), jlosses.mel_filterbank(*args))
    np.testing.assert_array_equal(tlosses.mel_filterbank(22050, 256, 20, htk=False),
                                  jlosses.mel_filterbank(22050, 256, 20, htk=False))
    x = _audio(0, 2, 1500)
    for n_fft, hop in ((128, 32), (64, 16)):
        held(tlosses.stft_mag(t(x), n_fft, hop), jlosses.stft_mag(jnp.asarray(x), n_fft, hop),
             TOL_OP, "stft_mag")
        held(tlosses.stft_mag(t(x), n_fft, hop, power=2.0),
             jlosses.stft_mag(jnp.asarray(x), n_fft, hop, power=2.0), TOL_OP, "stft_mag ** 2")
    np.testing.assert_array_equal(tlosses.safe_log(t(np.array([0.0, 1e-9, 2.0], np.float32))),
                                  jlosses.safe_log(jnp.asarray([0.0, 1e-9, 2.0])))


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    y, y_hat = _audio(2, 2, 4096), _audio(3, 2, 4096)
    held(tlosses.mel_loss(t(y_hat), t(y)), jlosses.mel_loss(jnp.asarray(y_hat), jnp.asarray(y)),
         TOL_OP, "mel_loss")
    held(tlosses.mel_loss(t(y_hat), t(y), n_fft=128, hop=32, n_mels=16),
         jlosses.mel_loss(jnp.asarray(y_hat), jnp.asarray(y), n_fft=128, hop=32, n_mels=16),
         TOL_OP, "mel_loss, small")
    assert float(tlosses.mel_loss(t(y), t(y))) == 0.0
    real = [rng.normal(size=(2, n)).astype(np.float32) for n in (7, 13)]
    fake = [rng.normal(size=(2, n)).astype(np.float32) for n in (7, 13)]
    fr = [[rng.normal(size=(2, 3, 5, 2)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    ff = [[a + rng.normal(size=a.shape).astype(np.float32) for a in maps] for maps in fr]
    j = lambda xs: [jnp.asarray(a) for a in xs]
    T = lambda xs: [t(a) for a in xs]
    for name, ours, theirs in (
            ("disc_hinge", tlosses.disc_hinge_loss(T(real), T(fake)),
             jlosses.disc_hinge_loss(j(real), j(fake))),
            ("gen_hinge", tlosses.gen_hinge_loss(T(fake)), jlosses.gen_hinge_loss(j(fake))),
            ("feature_matching", tlosses.feature_matching_loss([T(m) for m in fr],
                                                               [T(m) for m in ff]),
             jlosses.feature_matching_loss([j(m) for m in fr], [j(m) for m in ff])),
            ("lsgan_disc", tlosses.lsgan_disc_loss(T(real), T(fake)),
             jlosses.lsgan_disc_loss(j(real), j(fake))),
            ("lsgan_gen", tlosses.lsgan_gen_loss(T(fake)), jlosses.lsgan_gen_loss(j(fake)))):
        held(ours, theirs, TOL_OP, name)


# ------------------------------------------------------ discriminators.py
@pytest.mark.parametrize("n", [1, 5, 6, 7, 12, 100])
@pytest.mark.parametrize("k,stride,dil", [(5, 3, 1), (9, 2, 1), (3, 1, 1), (9, 2, 4), (3, 2, 2)])
def test_same_pads_match_xla(n, k, stride, dil):
    ((lo, hi),) = jax.lax.padtype_to_pads((n,), ((k - 1) * dil + 1,), (stride,), "SAME")
    assert tdisc.same_pads(n, k, stride, dil) == (lo, hi)


def _perturb(module, seed):
    """Every 1-D parameter (g, bias) off its init, so the test sees them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return module


def _disc_pair(kind, seed):
    """(port module, JAX module, JAX params carried from the port's weights)."""
    build = {
        "mpd": (lambda m: m.MultiPeriodDiscriminator(periods=(2, 3))),
        "mrd": (lambda m: m.MultiResolutionDiscriminator(resolutions=((256, 64), (128, 32)))),
        "msstft": (lambda m: m.MultiScaleSTFTDiscriminator(scales=((128, 32),), filters=8)),
        "dac": (lambda m: m.DACDiscriminator(periods=(3,), stft_resolutions=((128, 32),))),
    }[kind]
    port = _perturb(tdisc.init_discriminator_params(build(tdisc),
                                                    torch.Generator().manual_seed(seed)), seed)
    jmod = build(jdisc)
    params = convert.discriminator_state_dict_to_jax(port.state_dict())
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 700)))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    for (path, s), (_, v) in zip(jax.tree_util.tree_leaves_with_path(shapes),
                                 jax.tree_util.tree_leaves_with_path(params)):
        assert s.shape == v.shape, path
    return port, jmod, params


@pytest.mark.parametrize("kind", ["mpd", "mrd", "msstft", "dac"])
def test_discriminators_match_jax(kind):
    """Scores and every feature map at lengths where XLA's SAME padding is
    asymmetric (odd totals, strides 2 and 3) and the period pad reflects;
    the bridge round-trips the weights."""
    port, jmod, params = _disc_pair(kind, seed=4)
    again = convert.discriminator_state_dict_from_jax(params)
    assert set(again) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(again[k], v), k
    x = _audio(5, 2, 1001)
    jouts, jmaps = jax.jit(jmod.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        outs, maps = port(t(x))
    assert len(outs) == len(jouts) and len(maps) == len(jmaps)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        held(o, jo, TOL_DEEP, f"{kind} score {i}")
        assert len(maps[i]) == len(jmaps[i])
        for j, (f, jf) in enumerate(zip(maps[i], jmaps[i])):
            held(f.permute(0, 2, 3, 1), jf, TOL_DEEP, f"{kind} map {i}.{j}")


def test_wnconv_starts_as_a_plain_conv():
    conv = tdisc.WNConv(3, 5, (3, 9), strides=(1, 2))
    conv.reset_parameters(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(conv.g.detach(), conv.norm().detach(), rtol=1e-7)
    x = torch.randn(2, 3, 7, 20, generator=torch.Generator().manual_seed(1))
    y = conv(x)
    ref = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (3, 4, 1, 1)), conv.v, conv.bias,
                                     stride=(1, 2))
    assert y.shape == (2, 5, 7, 10)
    np.testing.assert_allclose(y.detach(), ref.detach(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- vq.py, training
def test_vq_training_half_matches_jax_with_injected_draws():
    rng = np.random.default_rng(6)
    key = jax.random.PRNGKey(3)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    # k-means from the rows jax.random.choice draws
    idx = np.asarray(jax.random.choice(key, 40, (12,), replace=False))
    held(tvq.kmeans_init(None, t(x), 12, iters=5, idx=t(idx)),
         jvq.kmeans_init(key, jnp.asarray(x), 12, iters=5), TOL_OP, "kmeans_init")
    # more bins than rows: drawn with replacement
    few = x[:5]
    idx_few = np.asarray(jax.random.choice(key, 5, (8,), replace=True))
    held(tvq.kmeans_init(None, t(few), 8, iters=3, idx=t(idx_few)),
         jvq.kmeans_init(key, jnp.asarray(few), 8, iters=3), TOL_OP, "kmeans_init, few rows")

    jq = jvq.VectorQuantizer.create(key, 2, 16, 8)
    jq = jq.replace(cluster_size=jnp.asarray(rng.uniform(0, 4, size=(2, 16)).astype(np.float32)))
    tq = tvq.VQState(embed=t(np.asarray(jq.embed)), cluster_size=t(np.asarray(jq.cluster_size)),
                     embed_avg=t(np.asarray(jq.embed_avg)))
    batch = rng.normal(size=(3, 10, 8)).astype(np.float32)
    draws = [t(np.asarray(jax.random.choice(jax.random.fold_in(key, i), 30, (16,), replace=True)))
             for i in range(2)]
    je = jvq.expire_dead_codes(key, jq, jnp.asarray(batch))
    te = tvq.expire_dead_codes(None, tq, t(batch), idx=draws)
    np.testing.assert_array_equal(te.embed.numpy(), np.asarray(je.embed))
    assert int((tq.cluster_size < 2.0).sum()) > 0  # some codes were dead

    lat = rng.normal(size=(2, 10, 8)).astype(np.float32)
    for n_q in (1, 2):
        jr = jvq.vq_train_step(jnp.asarray(lat), je, n_q)
        tr = tvq.vq_train_step(t(lat), te, n_q)
        np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
        held(tr.quantized, jr.quantized, TOL_OP, "straight-through")
        held(tr.commit_loss, jr.commit_loss, TOL_OP, "commit")
        for f in ("embed", "cluster_size", "embed_avg"):
            held(getattr(tr.quantizer, f), getattr(jr.quantizer, f), TOL_OP, f)
    # the straight-through estimator: the gradient reaches x as identity
    xg = t(lat).requires_grad_(True)
    tvq.vq_train_step(xg, te, 1).quantized.sum().backward()
    assert torch.equal(xg.grad, torch.ones_like(xg))
    # the JAX functions' axis_name is a dp process group here (its reduction
    # over two ranks: tests/test_torch_parallel.py); None is one process
    for fn, args, field in ((tvq.ema_codebook_update, (t(lat), tr.codes, te), "embed"),
                            (tvq.vq_train_step, (t(lat), te, 1), "quantized"),
                            (tvq.expire_dead_codes, (None, te, t(batch)), "embed")):
        kw = dict(idx=draws) if fn is tvq.expire_dead_codes else {}
        assert torch.equal(getattr(fn(*args, group=None, **kw), field),
                           getattr(fn(*args, **kw), field))
        with pytest.raises(TypeError, match="axis_name"):
            fn(*args, axis_name="dp")


# ----------------------------------------------------------------- gan.py
def test_mel_coeff_at_matches_jax():
    cfg = tgan.CodecGanConfig(decay_mel_coeff=True, num_warmup_steps=10, max_steps=110)
    jcfg = jgan.CodecGanConfig(decay_mel_coeff=True, num_warmup_steps=10, max_steps=110)
    for step in (0, 9, 10, 40, 110, 500):
        assert math.isclose(tgan.mel_coeff_at(cfg, step), float(jgan.mel_coeff_at(jcfg, step)),
                            rel_tol=1e-6)
    assert tgan.mel_coeff_at(tgan.CodecGanConfig(), 7) == 45.0


def _small_mel(orig):
    return lambda a, b, sample_rate: orig(a, b, sample_rate=sample_rate, n_fft=128, hop=32,
                                          n_mels=16)


@pytest.mark.parametrize("pretrain", [0, 5], ids=["adversarial", "pretrain-mel"])
def test_gan_steps_match_jax(monkeypatch, pretrain):
    """From the same carried weights, one disc_step and one gen_step: the
    losses, then every updated parameter of the generator and both
    discriminators, within 1e-4 of the leaf's max|ref|. The SEANet encoder
    takes no gradient (the codes are an argmax) and is only decayed."""
    monkeypatch.setattr(jgan, "mel_loss", _small_mel(jgan.mel_loss))
    monkeypatch.setattr(tgan, "mel_loss", _small_mel(tgan.mel_loss))
    cfg = WavTokenizerConfig(**TINY)
    wt = build_wavtokenizer(cfg, device="cpu", seed=7).train()
    _perturb(wt, 7)
    mpd = _perturb(tdisc.init_discriminator_params(
        tdisc.MultiPeriodDiscriminator(periods=(2,)), torch.Generator().manual_seed(8)), 8)
    mrd = _perturb(tdisc.init_discriminator_params(
        tdisc.MultiResolutionDiscriminator(resolutions=((64, 16),)),
        torch.Generator().manual_seed(9)), 9)
    gparams = convert.wavtokenizer_state_dict_to_jax(wt.state_dict())
    mparams = convert.discriminator_state_dict_to_jax(mpd.state_dict())
    rparams = convert.discriminator_state_dict_to_jax(mrd.state_dict())
    before = {name: {k: v.clone() for k, v in m.state_dict().items()}
              for name, m in (("generator", wt), ("mpd", mpd), ("mrd", mrd))}

    audio = _audio(10, 2, 256)
    jw, jm, jr = (JaxWavTokenizer(JaxConfig(**TINY)), jdisc.MultiPeriodDiscriminator(periods=(2,)),
                  jdisc.MultiResolutionDiscriminator(resolutions=((64, 16),)))
    jcfg = jgan.CodecGanConfig(pretrain_mel_steps=pretrain)
    jstate, gen_tx, disc_tx = jgan.create_codec_gan(jax.random.PRNGKey(0), jw, jm, jr,
                                                    jnp.asarray(audio), jcfg)
    jstate = jstate.replace(
        gen_params=gparams, disc_mpd=mparams, disc_mrd=rparams, gen_opt=gen_tx.init(gparams),
        disc_opt=disc_tx.init({"mpd": mparams, "mrd": rparams}))
    jd, jg = jgan.make_codec_gan_steps(jw, jm, jr, gen_tx, disc_tx, jcfg)
    jstate, jdm = jd(jstate, jnp.asarray(audio))
    jstate, jgm = jg(jstate, jnp.asarray(audio))

    tcfg = tgan.CodecGanConfig(pretrain_mel_steps=pretrain)
    state, gs, ds = tgan.create_codec_gan(None, wt, mpd, mrd, tcfg)
    td, tg = tgan.make_codec_gan_steps(gs, ds, tcfg)
    state, dm = td(state, t(audio))
    state, gm = tg(state, t(audio))
    assert (state.step, state.disc_step) == (1, 1) == (int(jstate.step), 1)

    held(dm["disc_loss"], jdm["disc_loss"], TOL_DEEP, "disc_loss")
    for k in ("mel_loss", "gen_adv", "fm_loss", "gen_loss"):
        held(gm[k], jgm[k], TOL_DEEP, k)
    lr, decay = tcfg.lr_gen, 1 - tcfg.lr_gen * tgan.ADAMW_WEIGHT_DECAY
    b1 = tcfg.betas[0]
    moments = {id(p): st["exp_avg"] for opt in (state.gen_opt, state.disc_opt)
               for p, st in opt.state.items()}
    jmu_gen, jmu_disc = jstate.gen_opt[0].mu, jstate.disc_opt[0].mu
    for name, module, jax_sd, jax_mu in (
            ("generator", wt, convert.wavtokenizer_state_dict_from_jax(jstate.gen_params),
             convert.wavtokenizer_state_dict_from_jax(jmu_gen)),
            ("mpd", mpd, convert.discriminator_state_dict_from_jax(jstate.disc_mpd),
             convert.discriminator_state_dict_from_jax(jmu_disc["mpd"])),
            ("mrd", mrd, convert.discriminator_state_dict_from_jax(jstate.disc_mrd),
             convert.discriminator_state_dict_from_jax(jmu_disc["mrd"]))):
        params = dict(module.named_parameters())
        assert set(params) == set(jax_sd) == set(jax_mu), name
        g_ref = {k: jax_mu[k].numpy() / (1 - b1) for k in params}
        g_port = {k: moments[id(p)].numpy() / (1 - b1) for k, p in params.items()}
        scale = max(np.abs(g).max() for g in g_ref.values())
        unresolved = total = 0
        for k, p in params.items():
            ours, ref, p0 = p.detach().numpy(), jax_sd[k].numpy(), before[name][k].numpy()
            assert np.abs(g_port[k] - g_ref[k]).max() <= TOL_DEEP * scale, (name, k)
            # a gradient that is zero in both (the encoder; codebook rows no
            # code chose): the element is only decayed
            zero = (g_ref[k] == 0) & (g_port[k] == 0)
            sure = zero | (np.abs(g_port[k] - g_ref[k]) < 0.1 * np.abs(g_ref[k]))
            held(np.where(sure, ours, ref), ref, TOL_DEEP, f"{name} {k}")
            assert np.abs(ours - ref).max() <= 2 * lr * 1.001, (name, k)
            if ".encoder." in k:  # no gradient: moved by weight decay alone
                assert zero.all(), k
                np.testing.assert_allclose(ours, p0 * decay, rtol=1e-7, atol=1e-12, err_msg=k)
            unresolved += int((~sure).sum())
            total += ours.size
        assert unresolved <= 0.01 * total, (name, unresolved, total)


# -------------------------------------------------------------- metrics.py
def test_metrics_match_jax():
    ref = _audio(11, 2, 5000)
    est = ref + _audio(12, 2, 5000) * 0.2
    for name, ours, theirs in (
            ("si_snr", tmetrics.si_snr(t(est), t(ref)), jmetrics.si_snr(jnp.asarray(est),
                                                                       jnp.asarray(ref))),
            ("lsd", tmetrics.log_spectral_distance(t(est), t(ref)),
             jmetrics.log_spectral_distance(jnp.asarray(est), jnp.asarray(ref))),
            ("mel", tmetrics.mel_distance(t(est), t(ref)),
             jmetrics.mel_distance(jnp.asarray(est), jnp.asarray(ref)))):
        held(ours, theirs, 1e-4, name)
    ours = tmetrics.quality_metrics(t(est), t(ref[:, :4900]))
    theirs = jmetrics.quality_metrics(jnp.asarray(est), jnp.asarray(ref[:, :4900]))
    assert set(ours) == set(theirs) == {"si_snr_db", "lsd_db", "mel_l1"}
    for k in ours:
        held(ours[k], theirs[k], 1e-4, k)
    for sr_in, sr_out in ((24000, 16000), (24000, 8000), (16000, 16000), (8000, 24000)):
        np.testing.assert_array_equal(tmetrics._resample_np(est, sr_in, sr_out),
                                      jmetrics._resample_np(est, sr_in, sr_out))


class _Mos(torch.nn.Module):
    def forward(self, wav: torch.Tensor, sr: int) -> torch.Tensor:
        return wav.abs().mean(-1) * 3.0 + float(sr) * 1e-4


def test_metric_hooks_policy_matches_jax(tmp_path):
    """UTMOS from a TorchScript module on disk scores as the JAX package's
    hook does; a path that fails to load warns and is left out; PESQ is
    attached only where its package imports (absent here and on the card)."""
    path = str(tmp_path / "mos.pt")
    torch.jit.script(_Mos()).save(path)
    est, ref = _audio(13, 2, 4800), _audio(14, 2, 4800)
    ours = tmetrics.external_metric_hooks(utmos_path=path)
    theirs = jmetrics.external_metric_hooks(utmos_path=path)
    assert set(ours) == set(theirs) and "utmos" in ours
    held(ours["utmos"](t(est), t(ref)), theirs["utmos"](jnp.asarray(est), jnp.asarray(ref)),
         1e-6, "utmos")
    with pytest.warns(UserWarning, match="utmos hook disabled"):
        hooks = tmetrics.external_metric_hooks(utmos_path=str(tmp_path / "missing.pt"))
    assert "utmos" not in hooks
    try:
        import pesq  # noqa: F401
    except ImportError:
        assert "pesq" not in hooks
    extra = tmetrics.quality_metrics(t(est), t(ref), extra_hooks=ours)
    assert "utmos" in extra and math.isfinite(float(extra["utmos"]))


# ---------------------------------------------------------- codec_cli.py
def test_codec_cli_fit_on_the_cpu(tmp_path):
    """``codec_cli fit --device cpu --tiny`` for 2 steps with a validation
    pass: finite JSONL metrics, a checkpoint of the generator, and ``--dp
    2`` in a single process raising (it trains under two processes:
    tests/test_torch_parallel.py)."""
    import json

    log = tmp_path / "metrics.jsonl"
    state = codec_cli.main(["fit", "--device", "cpu", "--tiny", "--steps", "2", "--crop-len",
                            "3072", "--log-every", "1", "--val-every", "1", "--ckpt-dir",
                            str(tmp_path / "ckpt"), "--log-file", str(log)])
    assert state.step == 2 and state.disc_step == 2
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 1]
    for r in recs:
        assert all(math.isfinite(v) for v in r.values()), r
    assert {"disc_loss", "gen_loss", "mel_loss", "fm_loss", "gen_adv"} <= set(recs[0])
    assert {"val_si_snr_db", "val_lsd_db", "val_mel_l1"} <= set(recs[2])
    saved = restore_checkpoint(str(tmp_path / "ckpt" / "step_2"))
    assert saved["step"] == 2
    for k, v in state.gen.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    with pytest.raises(ValueError, match="world size 1"):
        codec_cli.main(["fit", "--device", "cpu", "--tiny", "--steps", "1", "--dp", "2"])
