"""Plain float32 Whisper: the published architecture, written from
openai-whisper's ``model.py`` / ``audio.py`` and the Whisper paper.

It imports nothing of the program under test.  It reads the benchmark's
own parameter tree (the weights the benchmark made from the seed and
handed to both sides) and the benchmark's audio, and works out again what
the program derives from them: the log-mel, the encoder states, each
decoder layer's cross K/V, and the int4 cross cache the program reads
(symmetric int4 per (layer, row, head, channel) over the time axis, half
to even).  Every product runs in float32 with TF32 off.

``Precision("fp8")`` is the control: the same arithmetic with both inputs
of every product (the linear layers, the conv stem, attention's two
products and the logits) rounded to float8 e4m3, one scale for each row
of the left operand and each column of the right one: the precision one
step below the configuration's bfloat16.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
WINDOW_SAMPLES = 30 * SAMPLE_RATE
N_FRAMES = WINDOW_SAMPLES // HOP
FP8_MAX = 448.0


def full_fp32() -> None:
    """float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Tokens (openai-whisper's tokenizer.py layout, from the vocabulary size)
# ---------------------------------------------------------------------------

def special_tokens(n_vocab: int) -> dict:
    """Ids of the special tokens of a multilingual Whisper vocabulary:
    50,257 GPT-2 tokens, then eot, sot, the languages, translate,
    transcribe, startoflm, startofprev, nospeech, notimestamps and 1,501
    timestamps."""
    eot = 50257
    n_lang = n_vocab - 1501 - eot - 8
    sot = eot + 1
    st = dict(eot=eot, sot=sot, lang_begin=sot + 1, n_lang=n_lang)
    st["translate"] = sot + 1 + n_lang
    for i, k in enumerate(("transcribe", "startoflm", "startofprev", "no_speech",
                           "no_timestamps", "timestamp_begin")):
        st[k] = st["translate"] + 1 + i
    assert st["timestamp_begin"] + 1501 == n_vocab
    return st


# openai-whisper's SuppressTokens default (tokenizer.non_speech_tokens)
_SYMBOLS = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
    "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split())
_MISC = set("♩♪♫♬♭♮♯")


def suppressed_ids(st: dict, encode) -> list[int]:
    """openai's default suppress set (non-speech symbols and the specials
    it always suppresses) under the tokenizer's ``encode``."""
    ids = {encode(p)[0] for p in (" -", " '")}
    for sym in _SYMBOLS + sorted(_MISC):
        for variant in (sym, " " + sym):
            toks = encode(variant)
            if len(toks) == 1 or (toks and sym in _MISC):
                ids.add(toks[0])
    ids |= {st[k] for k in ("sot", "translate", "transcribe", "startoflm", "startofprev",
                            "no_speech")}
    return sorted(ids)


# ---------------------------------------------------------------------------
# Log-mel (openai-whisper audio.py: 400-point STFT, hop 160, Slaney mel)
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (math.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((math.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels) with Slaney
    normalisation, in float64: (n_mels, 201)."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    out = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, c, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (freqs - lo) / (c - lo)
        down = (hi - freqs) / (hi - c)
        out[i] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return out


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, 480000) float audio -> (B, n_mels, 3000) float32 log-mel, the
    transform in float64: |STFT|^2 with a periodic Hann window, reflect
    padding, the last frame dropped; mel; log10 floored at 1e-10 and at
    the window's peak - 8; (x + 4) / 4."""
    x = audio.double()
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=win, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.abs() ** 2
    filt = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    mel = filt @ power
    logm = torch.log10(torch.clamp(mel, min=1e-10))
    logm = torch.maximum(logm, logm.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return ((logm + 4.0) / 4.0).float()


# ---------------------------------------------------------------------------
# Arithmetic of one precision
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """"f32": float32 throughout.  "fp8": the control, whose products take
    float8 e4m3 inputs."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b, the operands rounded first in the control."""
        if self.kind == "fp8":
            a, b = _fp8(a, -1), _fp8(b, -2)
        return a @ b

    def linear(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        y = self.matmul(x, p["w"].float())  # w stored (d_in, d_out)
        return y + p["b"].float() if "b" in p else y

    def conv(self, p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
        w = p["w"].float()  # (C_out, C_in, 3)
        if self.kind == "fp8":
            x, w = _fp8(x, 1), _fp8(w.reshape(w.shape[0], -1), 1).reshape(w.shape)
        return F.conv1d(x, w, p["b"].float(), stride=stride, padding=1)


def _ln(p, x):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(), p["bias"].float(), 1e-5)


def _layer(blocks: dict, l: int) -> dict:
    return {k: _layer(v, l) if isinstance(v, dict) else v[l] for k, v in blocks.items()}


def _heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)  # (B, H, T, Dh)


def _attend(prec, q, k, v, mask=None):
    """softmax(q k^T / sqrt(Dh) + mask) v over (B, H, T, Dh)."""
    s = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s + mask
    o = prec.matmul(torch.softmax(s, dim=-1), v)
    return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)


# ---------------------------------------------------------------------------
# Encoder, cross cache, decoder
# ---------------------------------------------------------------------------

def encode(params: dict, cfg: dict, mel: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(B, n_mels, 3000) -> (B, 1500, d): conv stem with GELU, positions,
    pre-LN attention and MLP blocks, the final layer norm."""
    p = params["encoder"]
    x = F.gelu(prec.conv(p["conv1"], mel, 1))
    x = F.gelu(prec.conv(p["conv2"], x, 2)).transpose(1, 2) + p["pos_emb"].float()
    h = cfg["encoder_attention_heads"]
    for l in range(cfg["encoder_layers"]):
        bp = _layer(p["blocks"], l)
        xn = _ln(bp["attn_ln"], x)
        a = bp["attn"]
        o = _attend(prec, *(_heads(prec.linear(a[n], xn), h) for n in ("q", "k", "v")))
        x = x + prec.linear(a["out"], o)
        x = x + prec.linear(bp["fc2"], F.gelu(prec.linear(bp["fc1"], _ln(bp["mlp_ln"], x))))
    return _ln(p["ln_post"], x)


def int4_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """(B, T, d) K or V -> its int4 values times their scales: symmetric
    over T per (row, channel), scale = max |x| / 7, half to even."""
    scale = x.abs().amax(dim=1, keepdim=True).clamp(min=1e-8) / 7.0
    return torch.clamp(torch.round(x / scale), -7, 7) * scale


def cross_kv(params: dict, cfg: dict, states: torch.Tensor, prec: Precision, int4: bool):
    """Every decoder layer's cross K and V over ``states``, as the decode
    reads them: int4 values times scales when ``int4``."""
    out = []
    for l in range(cfg["decoder_layers"]):
        a = _layer(params["decoder"]["blocks"], l)["cross_attn"]
        k, v = prec.linear(a["k"], states), prec.linear(a["v"], states)
        out.append((int4_roundtrip(k), int4_roundtrip(v)) if int4 else (k, v))
    return out


def decode_logits(params: dict, cfg: dict, tokens: torch.Tensor, kv: list,
                  prec: Precision) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, T) against each layer's cross
    (K, V) -> logits (B, T, V), causal self-attention, logits against the
    token embedding."""
    p = params["decoder"]
    t = tokens.shape[1]
    h = cfg["decoder_attention_heads"]
    x = p["token_emb"][tokens].float() + p["pos_emb"][:t].float()
    mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    for l in range(cfg["decoder_layers"]):
        bp = _layer(p["blocks"], l)
        xn = _ln(bp["attn_ln"], x)
        a = bp["attn"]
        o = _attend(prec, *(_heads(prec.linear(a[n], xn), h) for n in ("q", "k", "v")), mask)
        x = x + prec.linear(a["out"], o)
        c = bp["cross_attn"]
        q = _heads(prec.linear(c["q"], _ln(bp["cross_attn_ln"], x)), h)
        k, v = kv[l]
        x = x + prec.linear(c["out"], _attend(prec, q, _heads(k, h), _heads(v, h)))
        x = x + prec.linear(bp["fc2"], F.gelu(prec.linear(bp["fc1"], _ln(bp["mlp_ln"], x))))
    return prec.matmul(_ln(p["ln"], x), p["token_emb"].float().T)


def language_probs(params: dict, cfg: dict, states: torch.Tensor, st: dict,
                   prec: Precision) -> torch.Tensor:
    """Language distribution of each row from one decoder step on <|sot|>
    against the unquantized cross K/V: (B, n_lang)."""
    kv = cross_kv(params, cfg, states, prec, int4=False)
    sot = torch.full((states.shape[0], 1), st["sot"], dtype=torch.long, device=states.device)
    logits = decode_logits(params, cfg, sot, kv, prec)[:, 0]
    lo = st["lang_begin"]
    return torch.softmax(logits[:, lo: lo + st["n_lang"]], dim=-1)
