"""The port's checkpoint conversion against the JAX package's, on the CPU.

Every converter is held leaf for leaf, bit-exact, to its JAX counterpart
on state dicts built here from seeds (no checkpoint is downloaded): a
``transformers`` Whisper at a tiny config, the same weights under openai's
names in a ``.pt``, a HuggingFace directory whose ``model.safetensors``
the port reads with its own reader, and pyannote/ResNet state dicts with
the published module names.  Each package's ``.npz`` loads in the other
with equal arrays and sidecars.  Tolerances: bit-equal for conversions
and files; logits 3e-3 and encoder states 2e-4 against ``transformers``
(the JAX suite's, ``tests/test_whisper_model.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_processor_tpu.models.diarization import convert as jdconvert
from audio_processor_tpu.models.diarization import embedding as jemb
from audio_processor_tpu.models.diarization import segmentation_tpu as jseg_tpu
from audio_processor_tpu.models.whisper import convert as jconvert
from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.models.diarization import convert as dconvert
from audio_processor_tpu_torch.models.diarization import embedding as pemb
from audio_processor_tpu_torch.models.diarization import segmentation as pseg
from audio_processor_tpu_torch.models.diarization import segmentation_tpu as pseg_tpu
from audio_processor_tpu_torch.models.whisper import convert, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.models.whisper.tokenizer import _bytes_to_unicode

DIMS = dict(n_mels=80, n_audio_ctx=48, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=1024, n_text_ctx=32, n_text_state=64, n_text_head=2, n_text_layer=2)
CFG = WhisperConfig(name="conv", **DIMS)
JCFG = JConfig(name="conv", **DIMS)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_trees_equal(a, b):
    """Same structure, and every leaf equal in dtype, shape and bytes."""
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def assert_npz_equal(pa, pb):
    """Two .npz files: same members, each with equal dtype, shape and bytes
    (np.savez stamps each member with the time, so the files differ)."""
    with np.load(pa) as za, np.load(pb) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            x, y = za[k], zb[k]
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k


# ---------------------------------------------------------------------------
# Whisper: HF, openai, safetensors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_model():
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    hf_cfg = HFConfig(
        vocab_size=CFG.n_vocab, num_mel_bins=CFG.n_mels,
        encoder_layers=CFG.n_audio_layer, encoder_attention_heads=CFG.n_audio_head,
        decoder_layers=CFG.n_text_layer, decoder_attention_heads=CFG.n_text_head,
        d_model=CFG.n_audio_state, max_source_positions=CFG.n_audio_ctx,
        max_target_positions=CFG.n_text_ctx, encoder_ffn_dim=4 * CFG.n_audio_state,
        decoder_ffn_dim=4 * CFG.n_text_state, pad_token_id=0, bos_token_id=1,
        eos_token_id=2, decoder_start_token_id=3, suppress_tokens=[],
        begin_suppress_tokens=[],
    )
    return WhisperForConditionalGeneration(hf_cfg).eval()


def _openai_state_dict(hf_sd: dict) -> dict:
    """HF Whisper names -> openai-whisper's (the inverse of the mapping)."""
    sd = {}
    attn = {"q_proj": "query", "k_proj": "key", "v_proj": "value", "out_proj": "out"}
    for k, v in hf_sd.items():
        if not k.startswith("model."):
            continue  # proj_out: tied to the token embedding
        k = k[len("model."):]
        k = (k.replace("embed_positions.weight", "positional_embedding")
              .replace("embed_tokens", "token_embedding")
              .replace("layers.", "blocks.")
              .replace("self_attn_layer_norm", "attn_ln")
              .replace("encoder_attn_layer_norm", "cross_attn_ln")
              .replace("final_layer_norm", "mlp_ln")
              .replace("self_attn.", "attn.")
              .replace("encoder_attn.", "cross_attn.")
              .replace("fc1", "mlp.0").replace("fc2", "mlp.2"))
        if k == "encoder.layer_norm.weight" or k == "encoder.layer_norm.bias":
            k = k.replace("layer_norm", "ln_post")
        if k.startswith("decoder.layer_norm."):
            k = k.replace("layer_norm", "ln")
        for a, b in attn.items():
            k = k.replace(f".{a}.", f".{b}.")
        sd[k] = v
    return sd


def test_from_hf_state_dict_equals_jax(hf_model):
    sd = hf_model.state_dict()
    ours = convert.from_hf_state_dict(sd, CFG)
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(ours))
    assert_trees_equal(convert.params_to_jax(ours), _np_tree(jconvert.from_hf_state_dict(sd, JCFG)))
    # the "model." root is optional
    bare = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    assert_trees_equal(convert.params_to_jax(convert.from_hf_state_dict(bare, CFG)),
                       convert.params_to_jax(ours))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_openai_checkpoint_equals_jax(hf_model, tmp_path, dtype):
    """A .pt with openai's names and a dims dict; a bf16 checkpoint is
    upcast before .numpy() by both."""
    sd = {k: v.to(dtype) for k, v in _openai_state_dict(hf_model.state_dict()).items()}
    path = str(tmp_path / "oa.pt")
    torch.save({"dims": dict(DIMS), "model_state_dict": sd}, path)
    heads = ((1, 0), (1, 1))
    ours, cfg = convert.load_openai_checkpoint(path, alignment_heads=heads)
    ref, jcfg = jconvert.load_openai_checkpoint(path, alignment_heads=heads)
    assert_trees_equal(convert.params_to_jax(ours), _np_tree(ref))
    assert {k: getattr(cfg, k) for k in DIMS} == {k: getattr(jcfg, k) for k in DIMS}
    assert cfg.alignment_heads == jcfg.alignment_heads == heads
    assert_trees_equal(convert.params_to_jax(convert.from_openai_state_dict(sd, CFG)),
                       _np_tree(jconvert.from_openai_state_dict(sd, JCFG)))


def test_converted_logits_match_transformers(hf_model, rng):
    params = convert.from_hf_state_dict(hf_model.state_dict(), CFG)
    mel = rng.normal(0, 1, (2, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    tokens = rng.integers(0, CFG.n_vocab, (2, 7))
    with torch.no_grad():
        enc = hf_model.model.encoder(torch.from_numpy(mel)).last_hidden_state
        dec = hf_model.model.decoder(input_ids=torch.from_numpy(tokens),
                                     encoder_hidden_states=enc).last_hidden_state
        ref_logits = (dec @ hf_model.model.decoder.embed_tokens.weight.T).numpy()
        audio = model.encode(params, CFG, torch.from_numpy(mel))
        logits = model.decode_logits(params, CFG, torch.from_numpy(tokens), audio)
    np.testing.assert_allclose(audio.numpy(), enc.numpy(), atol=2e-4)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=3e-3)


def _write_safetensors_dir(d, sd_np: dict, shards: int, dtype=np.float32):
    """A HF checkpoint directory: config, generation config, weights (one
    file or an index over ``shards`` files), byte-level vocab."""
    from safetensors.numpy import save_file

    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "num_mel_bins": CFG.n_mels, "max_source_positions": CFG.n_audio_ctx,
        "d_model": CFG.n_audio_state, "encoder_attention_heads": CFG.n_audio_head,
        "encoder_layers": CFG.n_audio_layer, "vocab_size": CFG.n_vocab,
        "max_target_positions": CFG.n_text_ctx, "decoder_attention_heads": CFG.n_text_head,
        "decoder_layers": CFG.n_text_layer}))
    (d / "generation_config.json").write_text(json.dumps({"alignment_heads": [[1, 0], [0, 1]]}))
    enc = _bytes_to_unicode()
    (d / "vocab.json").write_text(json.dumps({enc[b]: b for b in range(256)}, ensure_ascii=False))
    (d / "merges.txt").write_text("#version: toy\n")
    sd_np = {k: v.astype(dtype) for k, v in sd_np.items()}
    if shards == 1:
        save_file(sd_np, str(d / "model.safetensors"))
        return
    names = sorted(sd_np)
    weight_map = {}
    for i in range(shards):
        part = names[i::shards]
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file({k: sd_np[k] for k in part}, str(d / fname))
        weight_map.update({k: fname for k in part})
    (d / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


@pytest.mark.parametrize("shards", [1, 3])
def test_load_hf_checkpoint_equals_jax(hf_model, tmp_path, shards):
    sd_np = {k: v.numpy() for k, v in hf_model.state_dict().items()}
    d = tmp_path / "ckpt"
    _write_safetensors_dir(d, sd_np, shards)
    ours, cfg, tok = convert.load_hf_checkpoint(str(d))
    ref, jcfg, jtok = jconvert.load_hf_checkpoint(str(d))
    assert_trees_equal(convert.params_to_jax(ours), _np_tree(ref))
    assert cfg == WhisperConfig(**{**jcfg.__dict__})
    assert cfg.alignment_heads == ((1, 0), (0, 1))
    text = "héllo wörld ✓"
    assert tok.encode(text) == jtok.encode(text) and tok.decode(tok.encode(text)) == text


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_read_safetensors_equals_safetensors(tmp_path, rng, dtype):
    import ml_dtypes
    from safetensors.numpy import load_file, save_file

    np_dtype = {"F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16}[dtype]
    tensors = {"a": rng.normal(0, 3, (3, 5)), "b.c": rng.normal(0, 1, (7,)),
               "scalar": np.array(2.5), "empty": np.zeros((0, 4))}
    tensors = {k: v.astype(np_dtype) for k, v in tensors.items()}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "np"})
    ours, ref = convert.read_safetensors(path), load_file(path)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        want = ref[k].astype(np.float32) if dtype == "BF16" else ref[k]
        assert ours[k].dtype == want.dtype and ours[k].shape == want.shape
        assert ours[k].tobytes() == want.tobytes()


def test_read_safetensors_index_sharded_equals_safetensors(hf_model, tmp_path):
    from safetensors.numpy import load_file

    d = tmp_path / "ckpt"
    _write_safetensors_dir(d, {k: v.numpy() for k, v in hf_model.state_dict().items()}, 3,
                           dtype=np.float16)
    index = json.loads((d / "model.safetensors.index.json").read_text())
    for shard in sorted(set(index["weight_map"].values())):
        ours, ref = convert.read_safetensors(str(d / shard)), load_file(str(d / shard))
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes()


# ---------------------------------------------------------------------------
# The .npz format, both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    from audio_processor_tpu.models.whisper import model as jmodel

    return _np_tree(jmodel.init_params(JCFG, jax.random.PRNGKey(0)))


def _tokenizer():
    from audio_processor_tpu_torch.models.whisper.tokenizer import BPETokenizer

    enc = _bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256)}
    vocab[enc[ord("h")] + enc[ord("e")]] = 256
    return BPETokenizer(vocab, [(enc[ord("h")], enc[ord("e")])])


def test_params_to_jax_inverts_params_from_jax(jax_params):
    ours = convert.params_from_jax(jax_params, "cpu")
    assert_trees_equal(convert.params_to_jax(ours), jax_params)
    # bf16 leaves are widened to float32 exactly
    bf = model.map_params(lambda t: t.to(torch.bfloat16), ours)
    widened = convert.params_to_jax(bf)
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(widened))
    assert_trees_equal(widened, convert.params_to_jax(model.map_params(lambda t: t.float(), bf)))


def test_npz_crosses_between_packages(jax_params, tmp_path):
    from audio_processor_tpu.models.whisper.tokenizer import BPETokenizer as JBPE

    heads = ((1, 0), (0, 1))
    tok = _tokenizer()
    jtok = JBPE.from_tiktoken_bytes(tok.to_tiktoken_bytes())
    jcfg = JConfig(name="conv", alignment_heads=heads, **DIMS)
    cfg = WhisperConfig(name="conv", alignment_heads=heads, **DIMS)
    j_path, p_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jconvert.save_params(j_path, jax.tree.map(jnp.asarray, jax_params), jcfg, tokenizer=jtok)
    convert.save_params(p_path, convert.params_from_jax(jax_params, "cpu"), cfg, tokenizer=tok)
    assert_npz_equal(j_path, p_path)
    # the port reads JAX's file, JAX reads the port's
    ours, got = convert.load_params(j_path, "cpu")
    assert_trees_equal(convert.params_to_jax(ours), jax_params)
    assert got.alignment_heads == heads and got == WhisperConfig(**{**cfg.__dict__, "name": "loaded"})
    ref, jgot = jconvert.load_params(p_path)
    assert_trees_equal(_np_tree(ref), jax_params)
    assert jgot.alignment_heads == heads
    assert convert.load_tokenizer(j_path).encode("hehe") == jconvert.load_tokenizer(p_path).encode("hehe")


def test_cli_convert_whisper_writes_jax_bytes(hf_model, tmp_path, capsys):
    """convert-whisper on a .pt and on an HF directory: the .npz equals the
    JAX CLI's member for member."""
    from audio_processor_tpu import cli as jcli

    pt = str(tmp_path / "oa.pt")
    torch.save({"dims": dict(DIMS), "model_state_dict": _openai_state_dict(hf_model.state_dict())},
               pt)
    d = tmp_path / "hf"
    _write_safetensors_dir(d, {k: v.numpy() for k, v in hf_model.state_dict().items()}, 1)
    for src, tag in ((pt, "pt"), (str(d), "hf")):
        ours, ref = str(tmp_path / f"{tag}-port.npz"), str(tmp_path / f"{tag}-jax.npz")
        cli.main(["convert-whisper", src, ours])
        out = capsys.readouterr().out
        jcli.main(["convert-whisper", src, ref])
        assert out == capsys.readouterr().out.replace(ref, ours)
        assert_npz_equal(ours, ref)


# ---------------------------------------------------------------------------
# Diarization
# ---------------------------------------------------------------------------

def _pyannet_state_dict(rng):
    from test_diarization_convert import _pyannet_state_dict as make

    from audio_processor_tpu.models.diarization import segmentation as jseg

    return make(jseg.SegmentationConfig(), rng)


def _resnet_state_dict(rng, embed_key="seg_1", blocks=(1, 1, 1, 1)):
    from test_diarization_convert import _resnet_state_dict as make

    return make(jemb.EmbeddingConfig(blocks=blocks), rng, embed_key)


def test_from_pyannet_state_dict_equals_jax(rng):
    sd = {f"model.{k}": torch.from_numpy(v) for k, v in _pyannet_state_dict(rng).items()}
    ours, cfg = dconvert.from_pyannet_state_dict(sd)
    ref, _ = jdconvert.from_pyannet_state_dict(sd)
    assert_trees_equal(ours, _np_tree(ref))
    assert isinstance(ours["lstm"], list) and cfg == pseg.SegmentationConfig()
    # the port's PyanNet takes the tree
    net = pseg.params_from_jax(ours, cfg)
    assert torch.equal(net.classifier.weight, torch.from_numpy(ours["classifier"]["w"].T))


@pytest.mark.parametrize("embed_key", ["seg_1", "fc"])
def test_from_resnet_state_dict_equals_jax(rng, embed_key):
    sd = _resnet_state_dict(rng, embed_key)
    jcfg = jemb.EmbeddingConfig(blocks=(1, 1, 1, 1))
    cfg = pemb.EmbeddingConfig(blocks=(1, 1, 1, 1))
    ours, _ = dconvert.from_resnet_state_dict(sd, cfg)
    ref, _ = jdconvert.from_resnet_state_dict(sd, jcfg)
    assert_trees_equal(ours, _np_tree(ref))
    net = pemb.params_from_jax(ours, cfg)
    assert_trees_equal(pemb.params_to_jax(net), ours)
    del sd[f"{embed_key}.weight"]
    with pytest.raises(KeyError):
        dconvert.from_resnet_state_dict(sd, cfg)


def test_diarizer_pack_crosses_between_packages(rng, tmp_path):
    seg, _ = dconvert.from_pyannet_state_dict(_pyannet_state_dict(rng))
    emb, _ = dconvert.from_resnet_state_dict(_resnet_state_dict(rng), pemb.EmbeddingConfig(
        blocks=(1, 1, 1, 1)))
    p_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    dconvert.save_diarizer_params(p_path, seg, emb)
    jdconvert.save_diarizer_params(j_path, jax.tree.map(jnp.asarray, seg),
                                   jax.tree.map(jnp.asarray, emb))
    assert_npz_equal(p_path, j_path)
    seg2, emb2 = dconvert.load_diarizer_params(j_path)
    assert_trees_equal(seg2, seg)
    assert_trees_equal(emb2, emb)
    jseg2, jemb2 = jdconvert.load_diarizer_params(p_path)
    assert_trees_equal(_np_tree(jseg2), seg)
    assert_trees_equal(_np_tree(jemb2), emb)


def test_segmentation_tpu_params_to_jax_inverts(rng):
    cfg = jseg_tpu.TpuSegmentationConfig(d_model=32, n_head=2, n_layer=2)
    tree = _np_tree(jseg_tpu.init_params(cfg, jax.random.PRNGKey(1)))
    pcfg = pseg_tpu.TpuSegmentationConfig(d_model=32, n_head=2, n_layer=2)
    assert_trees_equal(pseg_tpu.params_to_jax(pseg_tpu.params_from_jax(tree, pcfg)), tree)


def test_embedding_params_to_jax_inverts():
    cfg = jemb.EmbeddingConfig(base_channels=8, blocks=(2, 1, 1, 1), embed_dim=16)
    tree = _np_tree(jemb.init_params(cfg, jax.random.PRNGKey(2)))
    pcfg = pemb.EmbeddingConfig(base_channels=8, blocks=(2, 1, 1, 1), embed_dim=16)
    assert_trees_equal(pemb.params_to_jax(pemb.params_from_jax(tree, pcfg)), tree)


def test_cli_convert_diarizer_writes_jax_bytes(rng, tmp_path, capsys):
    """convert-diarizer on torch.save'd state dicts (one wrapped in
    {"state_dict": ...}): the pack equals the JAX CLI's."""
    from audio_processor_tpu import cli as jcli

    seg_pt, emb_pt = str(tmp_path / "seg.ckpt"), str(tmp_path / "emb.pt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in _pyannet_state_dict(rng).items()}},
               seg_pt)
    torch.save({k: torch.from_numpy(v) for k, v in _resnet_state_dict(rng, blocks=(3, 4, 6, 3))
                .items()}, emb_pt)
    ours, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    cli.main(["convert-diarizer", seg_pt, emb_pt, ours])
    jcli.main(["convert-diarizer", seg_pt, emb_pt, ref])
    out = capsys.readouterr().out
    assert f"converted -> {ours}" in out and f"converted -> {ref}" in out
    assert_npz_equal(ours, ref)
    assert os.path.getsize(ours) > 0
