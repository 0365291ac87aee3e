"""The port's sharded serving against the JAX package's, on the CPU.

The distributed cases run in one gloo world of 4 ranks (a (data, model)
mesh of dp2 x tp2, as JAX's ``make_mesh(n_devices=4, model_parallel=2)``),
spawned once for the module.  Each rank is a process of its own that
imports torch and the port only; the JAX references run here, in the
pytest process, and the ranks' results come back as numpy arrays.

The module imports jax only inside its tests: the spawned ranks import
this module to find the functions they run.
"""
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import traceback

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.models.whisper import convert, decode, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.ops.kernels import decode_attention as da
from audio_processor_tpu_torch.parallel import mesh as mesh_lib
from audio_processor_tpu_torch.parallel import multihost, sharding
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

WORLD = 4
# JAX's tests/test_parallel.py config
DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=512, n_text_ctx=32, n_text_state=64, n_text_head=2, n_text_layer=2)
CFG = WhisperConfig(name="shard-test", **DIMS)


# ---------------------------------------------------------------------------
# a gloo world of processes, spawned once, running module functions
# ---------------------------------------------------------------------------

def _worker(rank, world, store, inbox, outbox):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=60),
    )
    while True:
        job = inbox.get()
        if job is None:
            break
        fn, args = job
        try:
            outbox.put((rank, True, fn(*args)))
        except Exception:  # noqa: BLE001 -- reported to the test
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    """``run(fn, *args)`` calls the module-level ``fn(*args)`` on every rank
    and returns the results in rank order.  A failed or hung case tears
    the world down; the next ``run`` spawns a new one."""

    def __init__(self, size: int):
        self.size = size
        self.procs = None

    def _spawn(self):
        ctx = multiprocessing.get_context("spawn")
        # a file rendezvous: no port to race other test processes for
        self.tmp = tempfile.mkdtemp(prefix="gloo-world-")
        store = os.path.join(self.tmp, "store")
        self.inboxes = [ctx.Queue() for _ in range(self.size)]
        self.outbox = ctx.Queue()
        self.procs = [
            ctx.Process(target=_worker, args=(r, self.size, store, self.inboxes[r], self.outbox),
                        daemon=True)
            for r in range(self.size)
        ]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = 120.0) -> list:
        if self.procs is None:
            self._spawn()
        for box in self.inboxes:
            box.put((fn, args))
        results, errors = {}, []
        try:
            while len(results) < self.size and not errors:  # the first failure ends the case
                rank, ok, value = self.outbox.get(timeout=timeout)
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            errors.append(f"timed out after {timeout} s")
        if errors:
            self.close(force=True)
            raise AssertionError("\n".join(errors))
        return [results[r] for r in range(self.size)]

    def close(self, force: bool = False):
        if self.procs is None:
            return
        if not force:
            for box in self.inboxes:
                box.put(None)
        for p in self.procs:
            p.join(timeout=0 if force else 20)
            if p.is_alive():
                p.kill()
                p.join()
        self.procs = None
        shutil.rmtree(self.tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def world():
    w = World(WORLD)
    yield w
    w.close()


def _mesh(model_parallel=2):
    return mesh_lib.make_mesh(model_parallel, device="cpu")


@pytest.fixture(scope="module")
def jparams():
    import jax

    from audio_processor_tpu.models.whisper import model as jmodel
    from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig

    return jmodel.init_params(JConfig(name="shard-test", **DIMS), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jtree(jparams):
    """The JAX weights as a numpy tree, which the ranks load."""
    import jax

    return jax.tree.map(np.asarray, jparams)


def _jmesh():
    from audio_processor_tpu.parallel import mesh as jmesh_lib

    return jmesh_lib.make_mesh(n_devices=4, model_parallel=2)


# ---------------------------------------------------------------------------
# mesh, multihost, spec tree (no world needed)
# ---------------------------------------------------------------------------

def test_degenerate_mesh_without_a_process_group():
    """JAX's mesh on one device is 1x1 (``mesh.py:37-38``); so is the
    port's without a process group, and its collectives are identities."""
    m = _mesh(1)
    assert m.shape == {"data": 1, "model": 1} and (m.data_rank, m.model_rank) == (0, 0)
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh_lib.all_reduce(x, m) is x and mesh_lib.all_gather(x, m) is x
    assert mesh_lib.round_up_batch(5, m) == 5 and mesh_lib.round_up_batch(5, None) == 5
    assert m.local_rows(4) == slice(0, 4)
    with pytest.raises(ValueError, match="must divide"):
        _mesh(2)


def test_multihost_initialize_noop_and_incomplete_topology(monkeypatch):
    for var in ("APTPU_COORDINATOR", "APTPU_NUM_PROCESSES", "APTPU_PROCESS_ID",
                "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False  # single process: a no-op
    monkeypatch.setenv("APTPU_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="APTPU_NUM_PROCESSES, APTPU_PROCESS_ID"):
        multihost.initialize()
    monkeypatch.setenv("APTPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="APTPU_PROCESS_ID"):
        multihost.initialize()


def test_multihost_check_single_process(monkeypatch):
    for var in ("APTPU_COORDINATOR", "APTPU_NUM_PROCESSES", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    summary = multihost.check(device="cpu")
    assert summary["ok"] and summary["sum_got"] == 1.0 and summary["distributed"] is False


def test_resolve_device_names_the_current_card(monkeypatch):
    """A bare "cuda" resolves to the card ``set_device`` chose (the rank's
    card after ``multihost.initialize``), so it compares equal to the
    device of the tensors made there."""
    from audio_processor_tpu_torch.runtime.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_param_spec_matches_tree_and_jax():
    """The port's spec tree has the params tree's keys, and every leaf
    splits the axis that JAX's PartitionSpec puts on the model axis."""
    from audio_processor_tpu.parallel import sharding as jsharding

    params = model.init_params(CFG, torch.Generator().manual_seed(0))
    spec = sharding.whisper_param_spec(CFG)
    flat_p, flat_s = convert._flatten(params), convert._flatten(spec)
    assert set(flat_p) == set(flat_s)
    flat_j = convert._flatten(jsharding.whisper_param_spec())
    assert set(flat_j) == set(flat_s)
    for key, s in flat_s.items():
        jdim = list(flat_j[key]).index("model") if "model" in tuple(flat_j[key]) else None
        assert (None if s is None else s.dim) == jdim, key


# ---------------------------------------------------------------------------
# cases run by every rank of the world
# ---------------------------------------------------------------------------

def case_mesh():
    m = _mesh(2)
    m1 = _mesh(1)
    try:
        _mesh(3)
        bad = None
    except ValueError as exc:
        bad = str(exc)
    with_mh = multihost.make_multihost_mesh(2, device="cpu")
    try:
        multihost.make_multihost_mesh(3, device="cpu")
        bad_mh = None
    except ValueError as exc:
        bad_mh = str(exc)
    return dict(shape=m.shape, ranks=(m.data_rank, m.model_rank), rows=m.local_rows(6),
                round5=mesh_lib.round_up_batch(5, m), shape1=m1.shape, bad=bad,
                shape_mh=with_mh.shape, bad_mh=bad_mh,
                check=multihost.check(device="cpu"))


def test_mesh_shapes_in_a_world(world):
    """JAX ``test_parallel.py:29-37`` on a 4-rank world: dp2 x tp2 and 4 x 1
    meshes, model_parallel=3 refused, round_up_batch to the data axis; the
    host-aware mesh and the bring-up check's all-reduce of ones."""
    jm = _jmesh()
    from audio_processor_tpu.parallel import mesh as jmesh_lib

    out = world.run(case_mesh)
    for r, o in enumerate(out):
        assert o["shape"] == dict(jm.shape) == {"data": 2, "model": 2}
        assert o["ranks"] == (r // 2, r % 2)
        assert o["rows"] == slice(3 * (r // 2), 3 * (r // 2) + 3)
        assert o["round5"] == jmesh_lib.round_up_batch(5, jm) == 6
        assert o["shape1"] == {"data": 4, "model": 1}
        assert o["bad"] and "must divide" in o["bad"]
        assert o["shape_mh"] == {"data": 2, "model": 2} and "model_parallel=3" in o["bad_mh"]
        assert o["check"]["ok"] and o["check"]["sum_got"] == 4.0 and o["check"]["distributed"]


def case_shard_params(tree):
    params = convert.params_from_jax(tree, "cpu")
    local = sharding.shard_params(params, _mesh(2), CFG)
    flat = convert._flatten(local)
    assert all(t.is_contiguous() for t in flat.values())
    return {k: t.numpy() for k, t in flat.items()}


def test_shard_params_equal_jax_shards(world, jparams, jtree):
    """Each rank's slices equal JAX's NamedSharding shard on device (d, m)
    of the same dp2 x tp2 mesh, exactly (conv stem in the port's layout)."""
    from audio_processor_tpu.parallel import sharding as jsharding

    jm = _jmesh()
    sharded = convert._flatten(jsharding.shard_params(jparams, jm))
    out = world.run(case_shard_params, jtree)
    for r, flat in enumerate(out):
        dev = jm.devices[r // 2, r % 2]
        for key, arr in sharded.items():
            (shard,) = [s for s in arr.addressable_shards if s.device == dev]
            want = np.asarray(shard.data)
            if key in convert._CONV_KEYS:
                want = want.transpose(2, 1, 0)
            np.testing.assert_array_equal(flat[key], want, err_msg=key)
    assert out[0]["decoder/blocks/attn/q/w"].shape == (2, 64, 32)


def _int4_inputs():
    """JAX ``test_parallel.py:108-113``: L=2, B=8, H=4, Dh=8, Tpad=256."""
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (8, 1, 4, 8)).astype(np.float32)
    k8 = rng.integers(-7, 8, (2, 8, 4, 8, 256), dtype=np.int8)
    v8 = rng.integers(-7, 8, (2, 8, 4, 256, 8), dtype=np.int8)
    return q, k8, v8


def case_kernel5(q, k8, v8):
    m = _mesh(2)
    k4, v4 = da.pack_int4_time(torch.from_numpy(k8), torch.from_numpy(v8))
    rows, (lo, hi) = m.local_rows(q.shape[0]), mesh_lib.split_bounds(4, m)
    q_l = torch.from_numpy(q)[rows, :, lo:hi].contiguous()
    k_l, v_l = k4[:, rows, lo:hi].contiguous(), v4[:, rows, lo:hi].contiguous()
    before = da.cross_attention_int4_stacked_tp.launches
    outs = [da.cross_attention_int4_stacked_tp(m, q_l, k_l, v_l, layer, valid_len=250,
                                               n_head=4).numpy() for layer in (0, 1)]
    errors = []
    for n_head, q_bad in ((3, q_l[:, :, :1].contiguous()), (4, q_l[:, :, :1].contiguous())):
        try:
            da.cross_attention_int4_stacked_tp(m, q_bad, k_l[:, :, :1], v_l[:, :, :1], 0,
                                               valid_len=250, n_head=n_head)
        except ValueError as exc:
            errors.append(str(exc))
    # CPU tensors take the plain version, which is no launch
    return outs, errors, da.cross_attention_int4_stacked_tp.launches - before


def test_kernel5_rank_outputs_equal_jax_shard_map(world):
    """Kernel #5's plain version on each rank's (B/dp, H/tp) shard against
    JAX's ``cross_attention_int4_stacked_tp`` on the dp2 x tp2 mesh
    (interpret mode), within 2e-4; heads that do not split over tp raise
    as JAX's (``test_parallel.py:101-136``)."""
    import jax
    import jax.numpy as jnp

    from audio_processor_tpu.ops.pallas import decode_attention as jda

    q, k8, v8 = _int4_inputs()
    k4, v4 = jda.pack_int4_time(jnp.asarray(k8), jnp.asarray(v8))
    jm = _jmesh()
    refs = [np.asarray(jax.jit(lambda qq, kk, vv, l=layer: jda.cross_attention_int4_stacked_tp(
        jm, qq, kk, vv, jnp.int32(l), valid_len=250, interpret=True))(jnp.asarray(q), k4, v4))
        for layer in (0, 1)]
    out = world.run(case_kernel5, q, k8, v8)
    for r, (outs, errors, launches) in enumerate(out):
        d, m = divmod(r, 2)
        for layer in (0, 1):
            np.testing.assert_allclose(outs[layer], refs[layer][4 * d: 4 * d + 4, :, 2 * m: 2 * m + 2],
                                       atol=2e-4)
        assert "heads do not shard" in errors[0] and "expected 2 of 4" in errors[1]
        assert launches == 0


def case_cache(tree, states, bits):
    params = convert.params_from_jax(tree, "cpu")
    m = _mesh(2)
    local = sharding.shard_params(params, m, CFG)
    x = torch.from_numpy(states)[m.local_rows(states.shape[0])]
    c = decode.init_cache(local, CFG, x, 8, quantize_cross_kv=True, kernel_layout=bits == 4,
                          kv_bits=bits, mesh=m)
    return [t.numpy() for t in (c.cross_k, c.cross_v, c.cross_k_scale, c.cross_v_scale,
                                c.self_k)]


@pytest.mark.parametrize("bits", [4, 8])
def test_rank_cache_bytes_equal_unsharded_head_slice(world, jtree, bits):
    """The int4 (kernel layout) and int8 quantization is per (layer, row,
    head, channel), so a rank's cache bytes are exactly the head and row
    slice of the unsharded cache."""
    states = np.random.default_rng(5).normal(0, 1, (4, CFG.n_audio_ctx, 64)).astype(np.float32)
    params = convert.params_from_jax(jtree, "cpu")
    full = decode.init_cache(params, CFG, torch.from_numpy(states), 8, quantize_cross_kv=True,
                             kernel_layout=bits == 4, kv_bits=bits)
    head_axis = 2 if bits == 4 else 3  # int8 plain cache: (L, B, Ta, H, Dh)
    out = world.run(case_cache, jtree, states, bits)
    for r, (ck, cv, ks, vs, self_k) in enumerate(out):
        d, m = divmod(r, 2)
        rows = slice(2 * d, 2 * d + 2)
        for got, whole, axis in ((ck, full.cross_k, head_axis), (cv, full.cross_v, head_axis),
                                 (ks, full.cross_k_scale, 3), (vs, full.cross_v_scale, 3)):
            want = whole[:, rows].narrow(axis, m, 1).numpy()
            np.testing.assert_array_equal(got, want)
        assert self_k.shape == (2, 2, 1, 8, 32)  # (L, B/dp, H/tp, T, Dh): the model's Dh


def case_encode(tree, mel):
    params = convert.params_from_jax(tree, "cpu")
    m = _mesh(2)
    local = sharding.shard_params(params, m, CFG)
    x = torch.from_numpy(mel)[m.local_rows(mel.shape[0])]
    return model.encode(local, CFG, x, mesh=m).numpy()


def test_tp_encoder_equal_jax(world, jparams, jtree):
    """JAX ``test_parallel.py:48-58``: the encoder on dp2 x tp2 (rows split,
    heads and hidden units sharded) within 1e-4 of JAX's single-device
    encoder."""
    from audio_processor_tpu.models.whisper import model as jmodel
    from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig

    mel = np.random.default_rng(0).normal(0, 1, (4, 80, 64)).astype(np.float32)
    ref = np.asarray(jmodel.encode(jparams, JConfig(name="shard-test", **DIMS), mel))
    out = world.run(case_encode, jtree, mel)
    for r, got in enumerate(out):
        d = r // 2
        np.testing.assert_allclose(got, ref[2 * d: 2 * d + 2], atol=1e-4)
    np.testing.assert_array_equal(out[0], out[1])  # model ranks agree


def case_decode(tree, states, kw, beam, temperature=0.0, best_of=2):
    params = convert.params_from_jax(tree, "cpu")
    m = _mesh(2)
    local = sharding.shard_params(params, m, CFG)
    x = torch.from_numpy(states)[m.local_rows(states.shape[0])]
    st = decode.SpecialTokens.for_config(CFG)
    kw = dict(kw, sot_sequence=tuple(st.sot_sequence()), max_new_tokens=8, mesh=m)
    if beam:
        res = decode.beam_decode(local, CFG, x, beam_size=3, **kw)
    else:
        res = decode.greedy_decode(local, CFG, x, temperature=temperature, rng_seed=3,
                                   best_of=best_of, **kw)
    return res.tokens.numpy(), res.no_speech_prob.numpy()


@pytest.mark.parametrize("cache", ["float", "int4", "int4-self-int8"])
def test_tp_greedy_and_beam_equal_jax(world, jparams, jtree, cache):
    """JAX ``test_parallel.py:61-98`` on dp2 x tp2: greedy and beam-3 tokens
    equal to JAX's single-device decode, no-speech probabilities within
    1e-5; with the int4 cache the cross-attention runs kernel #5's path.
    The int8 self cache's per-token scales are per head, so each model
    rank quantizes its own heads as the whole cache would."""
    from audio_processor_tpu.models.whisper import decode as jdecode
    from audio_processor_tpu.models.whisper import model as jmodel
    from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig

    jcfg = JConfig(name="shard-test", **DIMS)
    mel = np.random.default_rng(1).normal(0, 1, (4, 80, 64)).astype(np.float32)
    states = np.asarray(jmodel.encode(jparams, jcfg, mel))
    kw = {"float": {}, "int4": dict(quantize_cross_kv=True, kv_bits=4),
          "int4-self-int8": dict(quantize_cross_kv=True, kv_bits=4, quantize_self_kv=True)}[cache]
    st = jdecode.SpecialTokens.for_config(jcfg)
    jkw = dict(kw, sot_sequence=tuple(st.sot_sequence()), max_new_tokens=8)
    refs = {False: jdecode.greedy_decode(jparams, jcfg, states, **jkw),
            True: jdecode.beam_decode(jparams, jcfg, states, beam_size=3, **jkw)}
    for beam, ref in refs.items():
        out = world.run(case_decode, jtree, states, kw, beam)
        for r, (tokens, nsp) in enumerate(out):
            d = r // 2
            np.testing.assert_array_equal(tokens, np.asarray(ref.tokens)[2 * d: 2 * d + 2])
            np.testing.assert_allclose(nsp, np.asarray(ref.no_speech_prob)[2 * d: 2 * d + 2],
                                       atol=1e-5)


@pytest.mark.parametrize("best_of", [1, 2])
def test_dp_tp_sampling_equals_one_process(world, jtree, best_of):
    """At T=1 each row draws from its stream in the whole batch (after the
    best_of expansion), so the dp2 x tp2 decode samples the tokens that one
    process decoding all four rows samples."""
    states = np.random.default_rng(2).normal(0, 1, (4, CFG.n_audio_ctx, 64)).astype(np.float32)
    kw = dict(quantize_cross_kv=True, kv_bits=4)
    out = world.run(case_decode, jtree, states, kw, False, 1.0, best_of)
    st = decode.SpecialTokens.for_config(CFG)
    one = dict(kw, sot_sequence=tuple(st.sot_sequence()), max_new_tokens=8, rng_seed=3,
               best_of=best_of)
    params = convert.params_from_jax(jtree, "cpu")
    single = decode.greedy_decode(params, CFG, torch.from_numpy(states), temperature=1.0, **one)
    greedy = decode.greedy_decode(params, CFG, torch.from_numpy(states), **one)
    assert not torch.equal(single.tokens, greedy.tokens)  # it did sample
    for r, (tokens, _) in enumerate(out):
        d = r // 2
        np.testing.assert_array_equal(tokens, single.tokens.numpy()[2 * d: 2 * d + 2])


def test_tp_ranks_agree_when_sampling(world, jtree):
    """At T>0 the model ranks of a group draw the same tokens (logits are
    identical after the all-reduce and the rows' streams are keyed alike):
    a rank that diverged would desync the collectives."""
    states = np.random.default_rng(2).normal(0, 1, (4, CFG.n_audio_ctx, 64)).astype(np.float32)
    out = world.run(case_decode, jtree, states, dict(quantize_cross_kv=True, kv_bits=4), False, 1.0)
    for d in range(2):
        np.testing.assert_array_equal(out[2 * d][0], out[2 * d + 1][0])
    assert not np.array_equal(out[0][0], out[2][0])  # the data ranks decode other rows


# ---------------------------------------------------------------------------
# the Transcriber on the mesh
# ---------------------------------------------------------------------------

# __graft_entry__.py:110-114: random weights emit no timestamp pairs
ASR_KW = dict(compute_dtype="float32", max_new_tokens=6, enable_fallback=False,
              no_speech_threshold=None, without_timestamps=True)


class LetterTokenizer:
    """decode: every id as a letter, so random-weight decodes have text
    (defined here: the ranks unpickle it without importing jax)."""

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


TRANSCRIBE_OPTIONS = {
    "greedy": {},
    "beam3": dict(beam_size=3),
    "timestamps": dict(without_timestamps=False, tokenizer=LetterTokenizer(), max_new_tokens=8),
    "condition-prompt-beam2": dict(
        without_timestamps=False, tokenizer=LetterTokenizer(), max_new_tokens=8, beam_size=2,
        condition_on_previous_text=True, condition_group_size=2, initial_prompt="hello"),
}


def case_transcribe(tree, cfg_dims, audio, kw):
    cfg = WhisperConfig(**cfg_dims)
    params = convert.params_from_jax(tree, "cpu")
    t = Transcriber(params=params, cfg=cfg, mesh=_mesh(2), **kw)
    out = t.transcribe(audio, remove_silence=False)
    return out["segments"], t.cross_kv_bits


def _assert_segments_equal(ref_segs, out_segs):
    """``__graft_entry__.py:115-134``: tokens, text and timestamps exactly
    equal, float diagnostics within 1e-5."""
    assert len(ref_segs) == len(out_segs), (ref_segs, out_segs)
    for a, b in zip(ref_segs, out_segs):
        assert set(a) == set(b), (a, b)
        for key in a:
            if isinstance(a[key], float):
                assert abs(a[key] - b[key]) <= 1e-5 * max(1.0, abs(a[key])), (key, a, b)
            else:
                assert a[key] == b[key], (key, a, b)


def _jax_transcriber(name, mesh, **kw):
    import jax

    from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber

    base = JTranscriber.random_init(name, **ASR_KW)
    j = JTranscriber(params=base.params, cfg=base.cfg, mesh=mesh, **{**ASR_KW, **kw})
    tree = jax.tree.map(np.asarray, base.params)
    dims = {k: getattr(base.cfg, k) for k in WhisperConfig.__dataclass_fields__}
    return j, tree, dims


@pytest.mark.parametrize("options", list(TRANSCRIBE_OPTIONS))
def test_transcriber_dp2_tp2_equal_jax(world, options):
    """``__graft_entry__.py:136-156``: the dp2 x tp2 Transcriber (greedy and
    beam 3; and with timestamps) returns on every rank the segments of
    JAX's Transcriber on ``make_mesh(n_devices=4, model_parallel=2)``."""
    kw = TRANSCRIBE_OPTIONS[options]
    jt, tree, dims = _jax_transcriber("test", _jmesh(), **kw)
    assert jt._tp_mesh is not None
    audio = np.random.default_rng(4).normal(0, 0.1, 65 * 16_000).astype(np.float32)
    ref = jt.transcribe(audio, remove_silence=False)
    out = world.run(case_transcribe, tree, dims, audio, {**ASR_KW, **kw})
    for segs, bits in out:
        assert bits == 4
        _assert_segments_equal(ref["segments"], segs)


def test_transcriber_heads_not_dividing_tp_fall_back_to_int8(world):
    """Three heads over tp=2: kernel #5 needs an even split, so the
    Transcriber falls back to the plain int8 cross-KV cache as JAX's does
    (``transcribe.py:408-417``); the heads split unevenly (2 + 1) and the
    segments still equal JAX's single-device Transcriber's."""
    import jax

    from audio_processor_tpu.models.whisper import model as jmodel
    from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
    from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber

    dims = dict(name="three-heads", n_mels=80, n_audio_ctx=1500, n_audio_state=96,
                n_audio_head=3, n_audio_layer=1, n_vocab=1024, n_text_ctx=64,
                n_text_state=96, n_text_head=3, n_text_layer=2)
    jcfg = JConfig(**dims)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(5))
    jt = JTranscriber(params=jp, cfg=jcfg, cross_kv_bits=8, **ASR_KW)
    audio = np.random.default_rng(6).normal(0, 0.1, 35 * 16_000).astype(np.float32)
    ref = jt.transcribe(audio, remove_silence=False)
    out = world.run(case_transcribe, jax.tree.map(np.asarray, jp), dims, audio, ASR_KW)
    for segs, bits in out:
        assert bits == 8
        _assert_segments_equal(ref["segments"], segs)


def case_retry_ladder(tree, cfg_dims, audio):
    cfg = WhisperConfig(**cfg_dims)
    t = Transcriber(params=convert.params_from_jax(tree, "cpu"), cfg=cfg, mesh=_mesh(2),
                    compute_dtype="float32", max_new_tokens=4, best_of=2,
                    logprob_threshold=1.0, compression_ratio_threshold=None,
                    no_speech_threshold=None, tokenizer=LetterTokenizer(),
                    temperature_ladder=(0.5, 1.0))
    return t.transcribe(audio, remove_silence=False)["segments"]


def test_transcriber_retry_ladder_on_a_mesh(world):
    """Every row fails a logprob gate of +1, so the T>0 rungs re-batch the
    failed rows of three windows (rounded to the data axis) across the
    data ranks; every rank returns the same segments, all from the last
    rung.  (Sampled tokens differ from JAX's draws, so this is not held
    to JAX.)"""
    _, tree, dims = _jax_transcriber("test", None)
    audio = np.random.default_rng(7).normal(0, 0.1, 65 * 16_000).astype(np.float32)
    out = world.run(case_retry_ladder, tree, dims, audio)
    assert out[0] and {s["temperature"] for s in out[0]} == {1.0}
    for segs in out[1:]:
        assert segs == out[0]


# ---------------------------------------------------------------------------
# dataclasses.replace on a model-parallel Transcriber keeps its shard
# ---------------------------------------------------------------------------

def _shapes(params) -> list:
    out = []
    model.map_params(lambda t: out.append(tuple(t.shape)), params)
    return out


@pytest.mark.parametrize("name", ["test", "small"])
@pytest.mark.parametrize("model_rank", [0, 1])
def test_replace_keeps_sharded_params(name, model_rank):
    """``dataclasses.replace`` runs ``__post_init__`` again: the params it
    is handed are this rank's slices already, and must stay as they are
    (they used to be sliced a second time: ``ValueError: axis 2 of size
    128 is not 256 equal blocks`` at the test config)."""
    import dataclasses

    m = mesh_lib.Mesh(1, 2, 0, model_rank, torch.device("cpu"), None, None)
    t = Transcriber.random_init(name, mesh=m, device="cpu")
    before = _shapes(t.params)
    r = dataclasses.replace(t, temperature=0.5)
    assert _shapes(r.params) == before
    assert r.params.layout == t.params.layout == (2, model_rank)
    # the shard's heads: half of the model's on this rank
    q_w = r.params["decoder"]["blocks"]["attn"]["q"]["w"]
    assert q_w.shape[-1] == r.cfg.n_text_state // 2
    # a replaced copy shares the weights (nothing is cast or moved again)
    assert r.params["decoder"]["token_emb"] is t.params["decoder"]["token_emb"]
    with pytest.raises(ValueError, match="already sharded"):
        sharding.shard_params(r.params, m, r.cfg)
    other = mesh_lib.Mesh(1, 2, 0, 1 - model_rank, torch.device("cpu"), None, None)
    with pytest.raises(ValueError, match="do not fit"):
        dataclasses.replace(t, mesh=other)
    with pytest.raises(ValueError, match="do not fit"):
        dataclasses.replace(t, mesh=None)


def case_replace_decode(tree, cfg_dims, audio):
    import dataclasses

    t = Transcriber(params=convert.params_from_jax(tree, "cpu"), cfg=WhisperConfig(**cfg_dims),
                    mesh=_mesh(2), tokenizer=LetterTokenizer(), **ASR_KW)
    r = dataclasses.replace(t, best_of=3, condition_group_size=4)  # no effect at T=0
    return [x.transcribe(audio, remove_silence=False)["segments"] for x in (t, r)]


def test_replaced_transcriber_decodes_the_same_tokens_on_dp1_tp2():
    """On a gloo world of 2 ranks (dp1 x tp2), a Transcriber rebuilt by
    ``dataclasses.replace`` decodes the tokens of the original."""
    _, tree, dims = _jax_transcriber("test", None)
    audio = np.random.default_rng(8).normal(0, 0.1, 35 * 16_000).astype(np.float32)
    w = World(2)
    try:
        out = w.run(case_replace_decode, tree, dims, audio)
    finally:
        w.close()
    for orig, replaced in out:
        assert orig and [s["tokens"] for s in replaced] == [s["tokens"] for s in orig]
        assert replaced == orig
    assert out[0] == out[1]
