"""The port's M-RoPE VLM and encoder-only audio model against the JAX
package's, weights carried across.

``REGISTRY[arch].reduced()`` of qwen2-vl-72b (M-RoPE sections (16, 8, 8)
over head dim 64) and hubert-xlarge (bidirectional, frame inputs, no
``embed`` leaf): the reference's ``init_params`` tree, read as numpy,
becomes the port's parameters (``models/convert.py``), and the random
inputs (tokens, patch and frame embeddings, labels, masks) are drawn with
numpy; the VLM's ``vision_mask`` and ``positions_thw`` are the reference's
``make_batch``'s, which the port's :func:`vision_layout` gives ``==``.  At
float32, on the CPU:

* ``mrope_angles`` at the reduced sections and at qwen2-vl-72b's (16, 24,
  24), on the stub's (t, h, w) positions, within 1e-6 (cos and sin of the
  same float32 angles); a text-only table ``==`` ``rope_angles``;
* the vision ``_embed`` ``==``; the parameter trees' leaf names, shapes
  and dtypes;
* ``forward_train`` logits and ``loss_fn``'s loss at atol/rtol 1e-5,
  gradients at 1e-4 of each leaf's largest; one bfloat16 case each at 2e-2
  of the largest logit (``tests/test_torch_families.py``'s rule);
* the VLM's prefill logits and cache, decode steps with and without
  ``positions_thw``, and greedy ``generate`` ``==`` the reference's
  ``ServingEngine``, which decodes at (length, length, length) (ROADMAP
  Queue C R3);
* ``_masked_loss`` with random, all-True and all-False masks; the
  encoder-only config refused by ``decode_step``, ``ServingEngine`` and
  the serve CLI;
* the kernel route (``attn_impl="pallas"``: on the CPU the flash kernel's
  plain version) at head dim 80, bidirectional, against the reference's
  ``"pallas_interpret"`` at ``tests/test_kernels.py``'s 1e-3; the input
  checks take head dim 80 for flash and refuse it for decode;
* ``SyntheticLM``'s audio and VLM batches, and the train and serve CLIs.

The ``gpu``-marked case holds the hd-80 CUDA kernel to its plain version
on the card and skips here.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import ServingEngine as RefEngine  # noqa: E402

from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from repro_torch.tree import flatten, leaf_names, unflatten  # noqa: E402

VLM, AUDIO = "qwen2-vl-72b", "hubert-xlarge"
ARCHS = [VLM, AUDIO]
B, PROMPT, NEW, CACHE = 3, 24, 8, 48          # tests/test_serve.py's shape
SEQ = 48                                       # forward / prefill length
TOL = dict(atol=1e-5, rtol=1e-5)

ref_prefill = jax.jit(ref_tf.prefill, static_argnums=0,
                      static_argnames="cache_len")
ref_decode = jax.jit(ref_tf.decode_step, static_argnums=0)
ref_forward = jax.jit(ref_tf.forward_train, static_argnums=0)


def config(arch, dtype="float32", **kw):
    return dataclasses.replace(REGISTRY[arch].reduced(), dtype=dtype, **kw)


def carried(cfg, seed=0):
    params = jax.jit(lambda key: ref_tf.init_params(cfg, key)[0])(
        jax.random.PRNGKey(seed))
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def ref_names(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def batches(cfg, b=2, s=SEQ, seed=0):
    """The same inputs for both packages: (reference batch, port batch).
    Random parts from numpy (float32, cast to the parameter dtype in each
    package); the VLM's mask and positions from the reference's
    ``make_batch``."""
    g = np.random.default_rng(seed)
    dt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    tdt = port_tf.param_dtype(cfg)
    if not cfg.embed_inputs:
        arrays = {"frames": g.standard_normal((b, s, cfg.d_model))
                  .astype(np.float32),
                  "labels": g.integers(0, cfg.vocab_size, (b, s))
                  .astype(np.int32),
                  "mask": g.random((b, s)) < 0.35}
        floats = ("frames",)
    else:
        arrays = {"tokens": g.integers(0, cfg.vocab_size, (b, s))
                  .astype(np.int32)}
        floats = ()
        if cfg.mrope_sections is not None:
            stub = ref_model.make_batch(cfg, InputShape("t", s, b, "train"),
                                        jax.random.PRNGKey(0))
            n_patches = stub["vision_embeds"].shape[1]
            arrays.update(
                vision_embeds=g.standard_normal((b, n_patches, cfg.d_model))
                .astype(np.float32),
                vision_mask=np.array(stub["vision_mask"]),
                positions_thw=np.array(stub["positions_thw"]))
            floats = ("vision_embeds",)
    ref = {k: jnp.asarray(v).astype(dt) if k in floats else jnp.asarray(v)
           for k, v in arrays.items()}
    port = {k: torch.from_numpy(v).to(tdt) if k in floats
            else torch.from_numpy(v) for k, v in arrays.items()}
    return ref, port


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    cfg = config(request.param)
    return (cfg, *carried(cfg))


@pytest.fixture(scope="module")
def vlm():
    cfg = config(VLM)
    return (cfg, *carried(cfg))


# -- M-RoPE, the vision embedding, the trees ------------------------------------

@pytest.mark.parametrize("sections, head_dim, s", [
    ((16, 8, 8), 64, SEQ), ((16, 24, 24), 128, 2048)])
def test_mrope_angles_match_reference(sections, head_dim, s):
    """On the stub's (t, h, w) positions (at qwen2-vl-72b's own sections
    and prompt of 2,048 too): the port's positions ``==`` the reference's,
    the tables within 1e-6; a text-only table (pos, pos, pos) ``==``
    ``rope_angles``' bits; sections that do not sum to head_dim / 2
    raise."""
    cfg = dataclasses.replace(REGISTRY[VLM], mrope_sections=sections,
                              head_dim=head_dim)
    stub = ref_model.make_batch(cfg, InputShape("t", s, 2, "train"),
                                jax.random.PRNGKey(0))
    _, mask, thw = port_model.vision_layout(2, s)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(stub["vision_mask"]))
    np.testing.assert_array_equal(thw.numpy(),
                                  np.asarray(stub["positions_thw"]))
    cos_r, sin_r = ref_layers.mrope_angles(stub["positions_thw"], sections,
                                           head_dim, cfg.rope_theta)
    cos_t, sin_t = port_layers.mrope_angles(thw, sections, head_dim,
                                            cfg.rope_theta)
    assert cos_t.shape == (2, s, head_dim // 2) and cos_t.dtype == torch.float32
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_r), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_r), atol=1e-6)
    pos = torch.arange(s)
    cos_m, sin_m = port_layers.mrope_angles(
        pos[None, :, None].expand(1, -1, 3), sections, head_dim,
        cfg.rope_theta)
    cos_p, sin_p = port_layers.rope_angles(pos, head_dim, cfg.rope_theta)
    assert torch.equal(cos_m[0], cos_p) and torch.equal(sin_m[0], sin_p)
    with pytest.raises(ValueError, match="must sum"):
        port_layers.mrope_angles(thw, (8, 8, 8), head_dim, cfg.rope_theta)


def test_vision_embed_matches_reference(vlm):
    """Patches replace the token embeddings at the vision positions, in
    order: ``==`` the reference's, and the text positions keep their
    token embeddings."""
    cfg, ref_params, port_params = vlm
    batch_r, batch_t = batches(cfg)
    x_r = np.asarray(ref_tf._embed(cfg, ref_params, batch_r))
    x_t = port_tf._embed(cfg, port_params, batch_t).numpy()
    np.testing.assert_array_equal(x_t, x_r)
    n_patches = batch_t["vision_embeds"].shape[1]
    np.testing.assert_array_equal(x_t[:, :n_patches],
                                  batch_t["vision_embeds"].numpy())
    np.testing.assert_array_equal(
        x_t[:, n_patches:],
        port_params["embed"][batch_t["tokens"][:, n_patches:].long()].numpy())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(arch, dtype):
    cfg = config(arch, dtype)
    ref_params, _ = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    port_params = port_tf.init_params(cfg, seed=0, device="cpu")
    assert leaf_names(port_params) == ref_names(ref_params)
    assert ("embed" in port_params) == cfg.embed_inputs
    for t, r in zip(flatten(port_params), jax.tree.leaves(ref_params)):
        assert tuple(t.shape) == r.shape
        assert str(t.dtype).split(".")[1] == str(r.dtype)


# -- forward, loss, gradients ---------------------------------------------------

def test_forward_loss_and_grads_match_reference_f32(family):
    cfg, ref_params, port_params = family
    batch_r, batch_t = batches(cfg)
    logits_r, _ = ref_forward(cfg, ref_params, batch_r)
    logits_t, aux_t = port_tf.forward_train(cfg, port_params, batch_t)
    np.testing.assert_allclose(f32(logits_t), f32(logits_r), **TOL)
    assert float(aux_t) == 0.0

    (loss_r, _), grads_r = jax.value_and_grad(
        lambda p: ref_model.loss_fn(cfg, p, batch_r), has_aux=True)(
            ref_params)
    leaves = [p.detach().requires_grad_() for p in flatten(port_params)]
    loss_t, metrics = port_model.loss_fn(
        cfg, unflatten(port_params, leaves), batch_t)
    grads_t = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_r), **TOL)
    assert float(metrics["loss"].detach()) == float(loss_t.detach())
    for name, gt, gr in zip(leaf_names(port_params), grads_t,
                            jax.tree.leaves(grads_r)):
        gr = f32(gr)
        np.testing.assert_allclose(f32(gt), gr, atol=1e-4 * np.abs(gr).max(),
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_bf16(arch):
    """Every position's logits within 2e-2 of the largest (bf16 rounds at
    other places in the two frameworks)."""
    cfg = config(arch, "bfloat16")
    ref_params, port_params = carried(cfg)
    batch_r, batch_t = batches(cfg)
    logits_r, _ = ref_forward(cfg, ref_params, batch_r)
    logits_t, _ = port_tf.forward_train(cfg, port_params, batch_t)
    assert logits_t.dtype == torch.bfloat16
    ref = f32(logits_r)
    np.testing.assert_allclose(f32(logits_t), ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["random", "all", "none"])
def test_masked_loss_matches_reference(kind):
    """The masked mean over the masked positions, over at least one: an
    all-False mask gives 0 in both."""
    cfg = config(AUDIO)
    g = np.random.default_rng(5)
    logits = g.standard_normal((2, 16, cfg.vocab_size)).astype(np.float32)
    labels = g.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    mask = {"random": g.random((2, 16)) < 0.35,
            "all": np.ones((2, 16), bool),
            "none": np.zeros((2, 16), bool)}[kind]
    want = float(ref_model._masked_loss(cfg, *map(jnp.asarray,
                                                  (logits, labels, mask))))
    got = float(port_model._masked_loss(cfg, *map(torch.from_numpy,
                                                  (logits, labels, mask))))
    np.testing.assert_allclose(got, want, **TOL)
    assert (got == 0.0) == (kind == "none")


# -- the VLM: prefill, decode, serving ------------------------------------------

def test_vlm_prefill_logits_and_cache_match_reference(vlm):
    cfg, ref_params, port_params = vlm
    batch_r, batch_t = batches(cfg)
    lr, cr = ref_prefill(cfg, ref_params, batch_r, cache_len=SEQ + 16)
    lt, ct = port_tf.prefill(cfg, port_params, batch_t, cache_len=SEQ + 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **TOL)
    assert leaf_names(ct) == ref_names(cr)
    for t, r in zip(flatten(ct), jax.tree.leaves(cr)):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **TOL)
    fresh = port_tf.init_cache(cfg, 2, SEQ + 16, device="cpu")
    assert leaf_names(fresh) == leaf_names(ct)
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(flatten(fresh), flatten(ct)))


@pytest.mark.parametrize("positions", ["default", "given"])
def test_vlm_decode_steps_match_reference(vlm, positions):
    """Four steps from the reference's prefill cache, carried across: at
    (length, length, length), or at the text positions that continue the
    prompt's grid (``positions_thw`` (B, 3))."""
    cfg, ref_params, port_params = vlm
    batch_r, batch_t = batches(cfg)
    _, cr = ref_prefill(cfg, ref_params, batch_r, cache_len=SEQ + 16)
    ct = params_from_numpy(jax.tree.map(np.asarray, cr), "cpu")
    nxt = int(batch_t["positions_thw"][0, -1, 0]) + 1
    tok = np.asarray(batch_t["tokens"][:, -1])
    for i in range(4):
        thw = np.full((2, 3), nxt + i, np.int32) \
            if positions == "given" else None
        lr, cr = ref_decode(cfg, ref_params, jnp.asarray(tok), cr,
                            None if thw is None else jnp.asarray(thw))
        lt, ct = port_tf.decode_step(
            cfg, port_params, torch.from_numpy(tok), ct,
            None if thw is None else torch.from_numpy(thw))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **TOL)
        for t, r in zip(flatten(ct), jax.tree.leaves(cr)):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), **TOL)
        tok = np.asarray(lr).argmax(-1).astype(np.int32)


def test_vlm_greedy_generate_matches_reference(vlm):
    cfg, ref_params, port_params = vlm
    batch_r, batch_t = batches(cfg, b=B, s=PROMPT, seed=1)
    r = RefEngine(cfg, ref_params, cache_len=CACHE).generate(batch_r, NEW)
    engine = ServingEngine(cfg, port_params, cache_len=CACHE)
    t = engine.generate(batch_t, NEW)
    assert t.steps == r.steps == NEW
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(r.tokens))
    np.testing.assert_allclose(t.logprobs.numpy(), np.asarray(r.logprobs),
                               atol=1e-4)
    again = engine.generate(batch_t, NEW)
    assert torch.equal(again.tokens, t.tokens)            # deterministic


def test_engines_decode_vlm_continuation_at_length(vlm):
    """ROADMAP Queue C R3, a behaviour of the reference that the port
    copies: both engines place the first new token at (length, length,
    length) = (24, 24, 24), while the prompt's last text token sits at
    length - n_patches + grid - 1 = 24 - 6 + 3 - 1 = 20, so positions 21-23
    are skipped.  The engines' first step agrees with a decode step at the
    default position and not with one at 21."""
    cfg, ref_params, port_params = vlm
    batch_r, batch_t = batches(cfg, b=B, s=PROMPT, seed=1)
    n_patches = batch_t["vision_embeds"].shape[1]
    grid = int(n_patches ** 0.5) + 1
    last = int(batch_t["positions_thw"][0, -1, 0])
    assert last == PROMPT - n_patches + grid - 1 == 20
    r = RefEngine(cfg, ref_params, cache_len=CACHE).generate(batch_r, 1)
    t = ServingEngine(cfg, port_params, cache_len=CACHE).generate(batch_t, 1)
    at_next = torch.full((B, 3), last + 1, dtype=torch.int32)
    lp = {}
    for name, thw in (("default", None), ("next", at_next)):
        logits, cache = port_tf.prefill(cfg, port_params, batch_t,
                                        cache_len=CACHE)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, _ = port_tf.decode_step(cfg, port_params, tok, cache, thw)
        lp[name] = torch.log_softmax(logits, -1).gather(
            -1, t.tokens[:, :1].long())[:, 0]
    np.testing.assert_allclose(t.logprobs[:, 0].numpy(),
                               np.asarray(r.logprobs)[:, 0], atol=1e-4)
    np.testing.assert_allclose(t.logprobs[:, 0].numpy(),
                               lp["default"].numpy(), atol=1e-6)
    assert not np.allclose(lp["next"].numpy(), lp["default"].numpy(),
                           atol=1e-4)


# -- the encoder: no decode step, the kernel route at head dim 80 ---------------

def test_encoder_has_no_decode_step(capsys):
    cfg = config(AUDIO)
    params = port_tf.init_params(cfg, seed=0, device="cpu")
    assert "embed" not in params
    cache = port_tf.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        port_tf.decode_step(cfg, params, torch.zeros(2, dtype=torch.int32),
                            cache)
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(cfg, params)
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="encoder-only"):
        main(["--device", "cpu", "--arch", AUDIO])


def test_kernel_route_hd80_bidirectional_matches_reference_interpret():
    """hubert's blocks at head dim 80 (4 heads of 80 over d 256) through
    attn_impl="pallas" (on the CPU: the flash kernel's plain version)
    against the reference's Pallas kernel in interpret mode, and the
    plain version alone against ``ref.flash_attention_ref``'s oracle."""
    cfg = config(AUDIO, head_dim=80)
    ref_params, port_params = carried(cfg)
    batch_r, batch_t = batches(cfg, s=40)
    lr, _ = ref_forward(dataclasses.replace(cfg, attn_impl="pallas_interpret"),
                        ref_params, batch_r)
    lt, _ = port_tf.forward_train(dataclasses.replace(cfg, attn_impl="pallas"),
                                  port_params, batch_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), atol=1e-3)
    loss_r, _ = ref_model.loss_fn(cfg, ref_params, batch_r)
    loss_t, _ = port_model.loss_fn(cfg, port_params, batch_t)
    np.testing.assert_allclose(float(loss_t), float(loss_r), **TOL)
    g = np.random.default_rng(11)
    q, k, v = (g.standard_normal((2, 40, 4, 80)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(ref_ops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=False, impl="pallas_interpret"))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_input_checks_take_head_dim_80(dtype):
    """The flash kernel is built for head dim 80 (hubert-xlarge); the
    decode kernel is not, and no model with a decode step needs it
    (ROADMAP Queue B, B13)."""
    t = torch.zeros((1, 4, 2, 80), dtype=dtype)
    assert 80 in fa.HEAD_DIMS and 80 not in da.HEAD_DIMS
    fa.check_kernel_inputs("flash_attention", t, t, t)
    with pytest.raises(ValueError, match="head dims"):
        fa.check_kernel_inputs("decode_attention", t[:, :1], t, t,
                               head_dims=da.HEAD_DIMS)


# -- data, CLIs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_stream_batches(arch):
    """Shapes and dtypes of ``make_batch``'s structure; a pure function of
    (seed, step); the VLM's mask and positions ``==`` the reference
    stream's; the audio mask rate near 0.35 (8,192 draws: 0.35 +- 0.02 is
    over 3.7 standard deviations)."""
    cfg = config(arch, "bfloat16")
    shape = InputShape("t", 512, 16, "train")
    pipe = SyntheticLM(cfg, shape, DataConfig(seed=3))
    batch = pipe.batch_at(5)
    g = torch.Generator()
    g.manual_seed(0)
    like = port_model.make_batch(cfg, shape, g)
    assert {k: (v.shape, v.dtype) for k, v in batch.items()} \
        == {k: (v.shape, v.dtype) for k, v in like.items()}
    again = SyntheticLM(cfg, shape, DataConfig(seed=3)).batch_at(5)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    other = pipe.batch_at(6)
    assert not all(torch.equal(batch[k], other[k]) for k in batch)
    if arch == VLM:
        ref = RefSyntheticLM(cfg, shape).batch_at(5)
        for key in ("vision_mask", "positions_thw"):
            np.testing.assert_array_equal(batch[key].numpy(),
                                          np.asarray(ref[key]))
        assert batch["tokens"].max() < cfg.vocab_size
    else:
        assert abs(float(batch["mask"].float().mean()) - 0.35) < 0.02
        assert int(batch["labels"].min()) >= 0 \
            and int(batch["labels"].max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch, capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--arch", arch, "--steps", "3", "--seq", "16",
          "--batch", "2", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke device=cpu" in out and "waste=" in out
    assert '"final_loss": NaN' not in out


def test_serve_cli_on_cpu_vlm(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", VLM, "--batch", "2",
          "--prompt-len", "12", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"arch={VLM}-smoke device=cpu batch=2 prompt=12 new=4" in out


# -- the hd-80 kernel on the card -------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (2, 128, 128, 4, 4, 80, False, 0, 0), (1, 130, 200, 4, 2, 80, False, 0, 0),
    (2, 130, 130, 4, 2, 80, True, 64, 0), (1, 64, 200, 4, 2, 80, True, 0, 136)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hd80_kernel_matches_plain_on_card(case, dtype):
    """Float32 within 2e-6, bfloat16 to one bf16 ulp (each rounds one
    float32 result once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernels have no CPU "
                    "mode")
    b, sq, skv, h, kv, hd, causal, window, q_offset = case
    g = np.random.default_rng(12)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(g.standard_normal(shape).astype(np.float32))
               .to(dt).cuda() for shape in
               ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    launches = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    tol = dict(atol=2e-6, rtol=2e-6) if dtype == "float32" \
        else dict(atol=1e-6, rtol=2.0 ** -7)
    np.testing.assert_allclose(f32(out), f32(fa.flash_attention_ref(q, k, v,
                                                                    **kw)),
                               **tol)
