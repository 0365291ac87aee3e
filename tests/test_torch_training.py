"""The port's trainers against the JAX package's, on the CPU.

Each trainer starts from the JAX initialiser's weights (carried across by
``params_from_jax``) and the same batch, and is held to JAX at these
tolerances, all float32:

- step 0's loss within 1e-5 relative;
- every gradient leaf within 1e-4 of that leaf's largest JAX magnitude;
- the port's AdamW fed JAX's gradients: parameters within 1e-6 of optax's;
- 5 steps: each loss within 1e-4 relative.

The embedding net runs its convs in bf16 by default, in both packages.
Its gradients are held in float32 (both forwards called with
``compute_dtype=float32`` here, in the test), and its bf16 steps' losses
within 2e-2 relative: bf16 convolutions round differently on the two
backends.  The sharded step runs in a gloo world of 4 ranks
(``test_torch_parallel.World``) and is held to one process within 1e-5.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_processor_tpu.models.diarization import embedding as jemb
from audio_processor_tpu.models.diarization import segmentation_tpu as jseg
from audio_processor_tpu.models.diarization.segmentation import powerset_matrix
from audio_processor_tpu.models.whisper import model as jmodel
from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
from audio_processor_tpu.training import diarization_trainer as jdt
from audio_processor_tpu.training import embedding_trainer as jet
from audio_processor_tpu.training import pytree_io as jpio
from audio_processor_tpu.training import train_step as jts
from audio_processor_tpu_torch.models.diarization import embedding as pemb
from audio_processor_tpu_torch.models.diarization import segmentation_tpu as pseg
from audio_processor_tpu_torch.models.whisper import convert
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.parallel import mesh as mesh_lib
from audio_processor_tpu_torch.parallel import sharding
from audio_processor_tpu_torch.training import checkpoint as pckpt
from audio_processor_tpu_torch.training import diarization_trainer as pdt
from audio_processor_tpu_torch.training import embedding_trainer as pet
from audio_processor_tpu_torch.training import pytree_io as ppio
from audio_processor_tpu_torch.training import train_step as pts
from test_torch_parallel import World

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_vocab=512, n_text_ctx=32, n_text_state=64, n_text_head=4, n_text_layer=2)
CFG = WhisperConfig(name="train", **DIMS)
JCFG = JConfig(name="train", **DIMS)
SEG = dict(window_s=2.0, d_model=32, n_head=2, n_layer=2)
EMB = dict(base_channels=8, blocks=(1, 1, 1, 1), embed_dim=16, crop_s=1.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _copy(tree):
    """A copy of a JAX tree: the JAX train steps donate their state."""
    return jax.tree.map(jnp.array, tree)


def assert_grads_close(ours: list, ref: list, rel: float = 1e-4, zero: frozenset = frozenset()):
    """Each leaf within rel of its largest reference magnitude.  ``zero``:
    leaves whose gradient is 0 in exact arithmetic (a key projection's bias
    adds one constant to every score of a softmax row), so both sides are
    round-off: they are held below 1e-6 of the largest gradient anywhere."""
    assert len(ours) == len(ref)
    ours = [np.asarray(a.detach() if isinstance(a, torch.Tensor) else a) for a in ours]
    ref = [np.asarray(b) for b in ref]
    top = max(float(np.abs(b).max()) for b in ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.shape == b.shape, i
        if i in zero:
            assert max(float(np.abs(a).max()), float(np.abs(b).max())) <= 1e-6 * top, i
            continue
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= rel * scale, (i, a.shape)


def assert_losses_close(ours, ref, rel):
    for a, b in zip(ours, ref):
        assert abs(float(a) - float(b)) <= rel * abs(float(b)), (ours, ref)


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper_case():
    rng = np.random.default_rng(0)
    b, t = 3, 8
    mel = rng.normal(0, 1, (b, 80, 64)).astype(np.float32)
    ti = rng.integers(0, 512, (b, t)).astype(np.int32)
    to = rng.integers(0, 512, (b, t)).astype(np.int32)
    mk = (rng.random((b, t)) > 0.3).astype(np.float32)
    jp = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
    jb = jts.Batch(*(jnp.asarray(a) for a in (mel, ti, to, mk)))
    pb = pts.Batch(*(torch.from_numpy(a) for a in (mel, ti, to, mk)))
    return jp, jb, pb


def _port_leaves_of(jax_tree):
    return pts.tree_leaves(convert.params_from_jax(_np(jax_tree), "cpu"))


def test_whisper_loss_and_grads_equal_jax(whisper_case):
    jp, jb, pb = whisper_case
    params = convert.params_from_jax(_np(jp), "cpu")
    jl, jg = jax.value_and_grad(jts.loss_fn)(jp, JCFG, jb)
    leaves = pts.tree_leaves(params)
    loss, grads = pts.value_and_grad(lambda: pts.loss_fn(params, CFG, pb), leaves)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert_grads_close(grads, _port_leaves_of(jg))
    assert not any(p.requires_grad for p in leaves)  # serving's flags come back


def test_decay_mask_is_jax_mask_on_stacked_leaves(whisper_case):
    jp, _, _ = whisper_case
    params = convert.params_from_jax(_np(jp), "cpu")
    flat = convert._flatten(params)
    ours = dict(zip(flat, pts._decay_mask(list(flat.values()))))
    ref = convert._flatten(jax.tree.map(bool, jts._decay_mask(jp)))
    assert ours == ref
    # stacked layer norms and biases decay; ln_post, ln and conv biases do not
    assert ours["encoder/blocks/attn_ln/scale"] and ours["decoder/blocks/fc1/b"]
    assert not any(ours[k] for k in ("encoder/ln_post/scale", "decoder/ln/bias",
                                     "encoder/conv1/b"))


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0, 50.0])
def test_adamw_on_jax_grads_equals_optax(whisper_case, grad_scale):
    """Two steps at two learning rates: below and above the clip."""
    jp, jb, _ = whisper_case
    _, jg = jax.value_and_grad(jts.loss_fn)(jp, JCFG, jb)
    jg = jax.tree.map(lambda g: g * grad_scale, jg)
    params = convert.params_from_jax(_np(jp), "cpu")
    leaves = pts.tree_leaves(params)
    state = pts.make_optimizer().init(leaves)
    jstate, jparams = jts.make_optimizer().init(jp), jp
    for lr in (1e-3, 3e-4):
        upd, jstate = jts.make_optimizer(lr).update(jg, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        state = pts.make_optimizer(lr).update(_port_leaves_of(jg), state, leaves)
    for a, b in zip(leaves, _port_leaves_of(jparams)):
        assert float((a - b).abs().max()) <= 1e-6
    assert state.count == 2


def test_whisper_five_steps_track_jax(whisper_case):
    jp, jb, pb = whisper_case
    params = convert.params_from_jax(_np(jp), "cpu")
    state = pts.TrainState(params, pts.make_optimizer().init(pts.tree_leaves(params)), 0)
    jstate = jts.TrainState(_copy(jp), jts.make_optimizer(1e-3).init(jp), jnp.int32(0))
    ours, ref = [], []
    for _ in range(5):
        jstate, jl = jts.train_step(jstate, JCFG, jb, lr=1e-3)
        state, loss = pts.train_step(state, CFG, pb, lr=1e-3)
        ref.append(jl)
        ours.append(loss)
    assert_losses_close(ours, ref, 1e-4)
    assert state.step == 5 and state.opt_state.count == 5


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_case():
    cfg = jseg.TpuSegmentationConfig(**SEG)
    member = powerset_matrix(cfg)
    lut = jdt.powerset_lookup(member)
    rng = np.random.default_rng(1)
    xs, ys = zip(*(jdt.synth_mixture(rng, cfg) for _ in range(3)))
    jstate = jdt.init_train_state(cfg, jax.random.PRNGKey(0), lr=1e-3)
    return cfg, member, lut, np.stack(xs), np.stack(ys), jstate


def test_powerset_lookup_and_synth_mixture_equal_jax():
    cfg = pseg.TpuSegmentationConfig(**SEG)
    member = powerset_matrix(cfg)
    assert np.array_equal(pdt.powerset_lookup(member), jdt.powerset_lookup(member))
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        (x, y), (jx, jy) = pdt.synth_mixture(a, cfg), jdt.synth_mixture(b, jseg.TpuSegmentationConfig(**SEG))
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
        assert pdt.labels_to_turns(y, 0.02) == jdt.labels_to_turns(jy, 0.02)
    probs = np.random.default_rng(6).random((4, 50, 3))
    labels = (np.random.default_rng(7).random((4, 50, 3)) > 0.6).astype(np.float32)
    assert pdt.calibrate_onset(probs, labels) == jdt.calibrate_onset(probs, labels)


def test_permutation_loss_ties_share_the_gradient():
    """Two slots silent on every frame: the permutations that swap them
    tie, and the gradient is split among the tied minima as JAX splits it
    (torch.min(dim=) would send all of it to one)."""
    cfg = jseg.TpuSegmentationConfig(**SEG)
    member = powerset_matrix(cfg)
    lut = jdt.powerset_lookup(member)
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 1, (2, 20, member.shape[0])).astype(np.float32)
    targets = np.zeros((2, 20, 3), np.float32)
    targets[:, 5:12, 0] = 1.0  # slot 0 speaks; slots 1 and 2 are silent throughout
    jl, jg = jax.value_and_grad(jdt.permutation_invariant_loss)(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(member), jnp.asarray(lut))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = pdt.permutation_invariant_loss(x, torch.from_numpy(targets),
                                          torch.from_numpy(member), torch.from_numpy(lut))
    (g,) = torch.autograd.grad(loss, x)
    loss = loss.detach()
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-7)


def test_segmentation_step_equals_jax(seg_case):
    cfg, member, lut, x, y, jstate = seg_case
    pcfg = pseg.TpuSegmentationConfig(**SEG)
    net = pseg.params_from_jax(_np(jstate.params), pcfg)
    args_t = [torch.from_numpy(a) for a in (x, y, member, lut)]
    args_j = [jnp.asarray(a) for a in (x, y, member, lut)]

    def jloss(p):
        return jdt.permutation_invariant_loss(jseg.forward(p, cfg, args_j[0]), *args_j[1:])

    jl, jg = jax.value_and_grad(jloss)(jstate.params)
    leaves = pts.tree_leaves(net)
    loss, grads = pts.value_and_grad(
        lambda: pdt.permutation_invariant_loss(net(args_t[0]), *args_t[1:]), leaves)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    k_bias = frozenset(i for i, (name, _) in enumerate(net.named_parameters())
                       if name.endswith(".k.b"))
    assert len(k_bias) == SEG["n_layer"]
    assert_grads_close(grads, pts.tree_leaves(pseg.params_from_jax(_np(jg), pcfg)), zero=k_bias)

    state = pdt.SegTrainState(net, pdt.make_optimizer(1e-3).init(leaves), 0)
    jstate = _copy(jstate)
    ours, ref = [], []
    for _ in range(5):
        jstate, jl = jdt.train_step(jstate, cfg, *args_j, lr=1e-3)
        state, loss = pdt.train_step(state, pcfg, *args_t, lr=1e-3)
        ref.append(jl)
        ours.append(loss)
    assert_losses_close(ours, ref, 1e-4)


def test_segmentation_checkpoint_equals_jax_and_serves(seg_case, tmp_path):
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer

    cfg, _, _, _, _, jstate = seg_case
    pcfg = pseg.TpuSegmentationConfig(**SEG)
    net = pseg.params_from_jax(_np(jstate.params), pcfg)
    ours, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    decode = {"offset": 0.4, "min_cluster_size": 3}
    pdt.save_params(ours, net, pcfg, onset=0.55, decode=decode)
    jdt.save_params(ref, jstate.params, cfg, onset=0.55, decode=decode)
    from test_torch_convert import assert_npz_equal

    assert_npz_equal(ours, ref)
    net2, cfg2 = pdt.load_params(ours)
    assert cfg2 == pcfg and all(torch.equal(a, b) for a, b in zip(net.parameters(), net2.parameters()))
    assert pdt.load_onset(ours) == 0.55 and pdt.load_decode_meta(ours) == jdt.load_decode_meta(ref)
    d = Diarizer.from_tpu_segmentation(ours, device="cpu")
    assert d.onset == 0.55 and d.offset == 0.4 and d.min_cluster_size == 3
    with pytest.raises(ValueError):
        pdt.save_params(ours, net, pcfg, decode={"bogus": 1.0})


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emb_case():
    cfg = jemb.EmbeddingConfig(**EMB)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 4, 6)
    crops = np.stack([jet.synth_speaker_crop(rng, 100 * 1.4 ** s, cfg) for s in labels])
    jstate = jet.init_train_state(cfg, 4, jax.random.PRNGKey(1), lr=1e-3)
    return cfg, labels, crops, jstate


def _port_emb_state(jstate, lr=1e-3):
    net = pemb.params_from_jax(_np(jstate.params), pemb.EmbeddingConfig(**EMB))
    head = torch.from_numpy(np.array(jstate.head_w))
    return pet.EmbTrainState(net, head, pet.make_optimizer(lr).init(pts.tree_leaves((net, head))), 0)


def test_synth_speaker_crop_equals_jax():
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    cfg = pemb.EmbeddingConfig(**EMB)
    for f0 in (110.0, 250.0):
        assert np.array_equal(pet.synth_speaker_crop(a, f0, cfg),
                              jet.synth_speaker_crop(b, f0, jemb.EmbeddingConfig(**EMB)))


def test_embedding_grads_equal_jax_in_float32(emb_case, monkeypatch):
    cfg, labels, crops, jstate = emb_case
    state = _port_emb_state(jstate)
    monkeypatch.setattr(jemb, "forward", functools.partial(jemb.forward, compute_dtype=jnp.float32))
    f32_forward = pemb.ResNetEmbedding.forward
    monkeypatch.setattr(pemb.ResNetEmbedding, "forward",
                        lambda self, feats: f32_forward(self, feats, torch.float32))
    # both losses see JAX's features: float32 fbanks from the two backends
    # differ by up to 8e-4 in log space at deep spectral nulls
    # (tests/test_torch_fbank.py compares them in float64), which would
    # move the stem's gradient by more than the training code does
    from audio_processor_tpu.ops import fbank as jfbank

    feats = torch.from_numpy(np.array(jfbank.fbank(jnp.asarray(crops), n_mels=cfg.n_mels)))
    monkeypatch.setattr(pet.fbank_lib, "fbank", lambda audio, n_mels: feats)

    def jloss(pw):
        return jet.aam_softmax_loss(pw[0], pw[1], cfg, jnp.asarray(crops), jnp.asarray(labels))

    jl, (jgp, jgh) = jax.value_and_grad(jloss)((jstate.params, jstate.head_w))
    leaves = pts.tree_leaves((state.params, state.head_w))
    loss, grads = pts.value_and_grad(lambda: pet.aam_softmax_loss(
        state.params, state.head_w, pemb.EmbeddingConfig(**EMB), torch.from_numpy(crops),
        torch.from_numpy(labels)), leaves)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    ref = pts.tree_leaves(pemb.params_from_jax(_np(jgp), pemb.EmbeddingConfig(**EMB)))
    assert_grads_close(grads, ref + [np.asarray(jgh)])


def test_embedding_bf16_steps_track_jax(emb_case):
    cfg, labels, crops, jstate = emb_case
    state = _port_emb_state(jstate)
    pcfg = pemb.EmbeddingConfig(**EMB)
    jstate = _copy(jstate)
    ours, ref = [], []
    for _ in range(5):
        jstate, jl = jet.train_step(jstate, cfg, jnp.asarray(crops), jnp.asarray(labels, jnp.int32),
                                    lr=1e-3)
        state, loss = pet.train_step(state, pcfg, torch.from_numpy(crops),
                                     torch.from_numpy(labels), lr=1e-3)
        ref.append(jl)
        ours.append(loss)
    assert_losses_close(ours, ref, 2e-2)
    assert state.params.stem_bn["mean"].requires_grad is False


def test_embedding_checkpoint_equals_jax(emb_case, tmp_path):
    from test_torch_convert import assert_npz_equal

    cfg, labels, crops, jstate = emb_case
    state = _port_emb_state(jstate)
    pcfg = pemb.EmbeddingConfig(**EMB)
    ours, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    pet.save_params(ours, state.params, pcfg, cluster_threshold=0.6)
    jet.save_params(ref, jstate.params, cfg, cluster_threshold=0.6)
    assert_npz_equal(ours, ref)
    net, cfg2 = pet.load_params(ref)
    assert cfg2 == pcfg and pet.load_cluster_threshold(ours) == 0.6
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), state.params.parameters()))
    sep = pet.embedding_separation(net, pcfg, crops, labels)
    assert np.isfinite(sep) and pet.embedding_separation(net, pcfg, crops[:1], labels[:1]) == 0.0


# ---------------------------------------------------------------------------
# pytree_io and the train-state checkpoint
# ---------------------------------------------------------------------------

def test_pytree_io_equals_jax():
    tree = {"a": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, {"w": np.ones(2, np.float32)}],
            "b": {"c": torch.tensor([1.5, 2.5], dtype=torch.bfloat16)}}
    jtree = {"a": tree["a"], "b": {"c": jnp.asarray([1.5, 2.5], jnp.bfloat16)}}
    ours, ref = ppio.flatten_tree(tree), jpio.flatten_tree(jtree)
    assert sorted(ours) == sorted(ref) == ["a.0.w", "a.1.w", "b.c"]
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes()
    back = ppio.unflatten_tree(ours)
    assert isinstance(back["a"], list) and np.array_equal(back["a"][0]["w"], tree["a"][0]["w"])


def test_train_state_checkpoint_roundtrip(whisper_case, seg_case, emb_case, tmp_path):
    jp, _, pb = whisper_case
    params = convert.params_from_jax(_np(jp), "cpu")
    state = pts.TrainState(params, pts.make_optimizer().init(pts.tree_leaves(params)), 0)
    state, _ = pts.train_step(state, CFG, pb, lr=1e-3)
    pcfg = pseg.TpuSegmentationConfig(**SEG)
    seg_state = pdt.init_train_state(pcfg, torch.Generator().manual_seed(0))
    emb_state = _port_emb_state(emb_case[3])
    for st, fresh in (
        (state, lambda: pts.init_train_state(CFG, torch.Generator().manual_seed(7))),
        (seg_state, lambda: pdt.init_train_state(pcfg, torch.Generator().manual_seed(7))),
        (emb_state, lambda: pet.init_train_state(pemb.EmbeddingConfig(**EMB), 4,
                                                 torch.Generator().manual_seed(7))),
    ):
        path = str(tmp_path / "state")
        pckpt.save_train_state(path, st)
        assert os.listdir(tmp_path) == ["state.npz"]  # no temporary left behind
        back = pckpt.restore_train_state(path, fresh())
        assert back.step == st.step and back.opt_state.count == st.opt_state.count
        for name in [f for f in st._fields if f not in ("opt_state", "step")]:
            for a, b in zip(pts.tree_leaves(getattr(st, name)), pts.tree_leaves(getattr(back, name))):
                assert torch.equal(a, b)
        for a, b in zip(st.opt_state.mu + st.opt_state.nu, back.opt_state.mu + back.opt_state.nu):
            assert torch.equal(a, b)
        os.remove(path + ".npz")
    pckpt.save_train_state(str(tmp_path / "seg.npz"), seg_state)
    with pytest.raises(ValueError):
        pckpt.restore_train_state(str(tmp_path / "seg.npz"), state)


# ---------------------------------------------------------------------------
# The sharded step: a gloo world of 4 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def _sharded_step(model_parallel: int):
    """One dp x tp step (the dry run) against the same step in one process,
    compared on this rank's slices.  Returns (sharded loss, one-process
    loss, largest parameter difference, mesh shape)."""
    loss, state = pts.dryrun_multichip(4, model_parallel, device="cpu")
    ref = pts.init_train_state(pts.DRYRUN_CONFIG, torch.Generator().manual_seed(0))
    mesh = mesh_lib.make_mesh(model_parallel, "cpu")
    batch = pts.dryrun_batch(mesh.dp)
    ref, ref_loss = pts.train_step(ref, pts.DRYRUN_CONFIG, batch)
    ref = pts.shard_train_state(ref, mesh, pts.DRYRUN_CONFIG)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        pts.tree_leaves(state.params) + state.opt_state.mu + state.opt_state.nu,
        pts.tree_leaves(ref.params) + ref.opt_state.mu + ref.opt_state.nu))
    return loss, float(ref_loss), diff, (mesh.dp, mesh.tp)


@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_sharded_step_equals_one_process(world, model_parallel):
    results = world.run(_sharded_step, model_parallel)
    for loss, ref_loss, diff, shape in results:
        assert shape == (4 // model_parallel, model_parallel)
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
        assert diff <= 1e-5
    assert len({r[0] for r in results}) == 1  # every rank reports the same loss


def test_sharded_serving_forward_is_unchanged_by_the_autograd_functions():
    """Without a gradient the two functions are the serving path's ops."""
    x = torch.randn(3, 4)
    assert mesh_lib.copy_to_model(x, None) is x
    assert mesh_lib.reduce_from_model(x, None) is x
    mesh = mesh_lib.Mesh(1, 2, 0, 0, torch.device("cpu"))
    assert mesh_lib.copy_to_model(x, mesh) is x  # no gradient: no function
    spec = sharding.whisper_param_spec(CFG)
    assert spec["decoder"]["blocks"]["cross_attn"]["out"]["w"] == sharding.Split(1, 4)
