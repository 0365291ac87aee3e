"""Kernel B's design probes in the port (``ops/kernels/probe_attention.py``)
against the JAX package's probes (``benchmarks/kernel_v32_probe.py``,
``kernel_v34_probe.py``, ``kernel_v4_probe.py``).

Each JAX probe is loaded from ``benchmarks/`` and its Pallas calls run in
interpret mode (``pallas_call`` patched to ``interpret=True``), as the JAX
suite runs Pallas kernels on the CPU.  The port's wrapper, given CPU tensors,
runs its plain version on the same numpy-seeded inputs, on layer 1, with an
even and an odd valid_len.  Tolerance 2e-4 (the JAX suite's for attention
kernels) for every exact and every quantised variant; the stream-only
checksum is bit-equal.  Small shapes: L=2, B=4, H=3, Dh=64, Tpad=256.
"""
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from audio_processor_tpu_torch.ops.kernels import decode_attention as da
from audio_processor_tpu_torch.ops.kernels import probe_attention as pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, B, H, DH, TPAD, BB = 2, 4, 3, 64, 256, 2


def _probe(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probes():
    return {n: _probe(n) for n in ("kernel_v32_probe", "kernel_v34_probe", "kernel_v4_probe")}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))


def _inputs(valid):
    rng = np.random.default_rng(valid)
    k8 = rng.integers(-7, 8, (L, B, H, DH, TPAD)).astype(np.int8)
    v8 = rng.integers(-7, 8, (L, B, H, TPAD, DH)).astype(np.int8)
    q = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    k4, v4 = da.pack_int4_time(torch.from_numpy(k8), torch.from_numpy(v8))
    return q, k8, v8, k4.numpy(), v4.numpy()


# variant -> (probe file, JAX call, port call, cache); the JAX call gets
# (probe module, q, K, V, layer, valid) as jax arrays, the port call torch ones
_J7 = lambda fu: lambda m, q, k, v, l, n: m._stacked_call(q, k, v, l, valid_len=n, fast_unpack=fu)
_J8 = lambda var: lambda m, q, k, v, l, n: m._stacked_call_v34(q, k, v, l, valid_len=n,
                                                               variant=var, bb=BB)
_J9 = lambda kern: lambda m, q, k, v, l, n: m._stacked_call(getattr(m, kern), q, k, v, l,
                                                            valid_len=n)
_EXACT = lambda q, k, v, l, n: pa.int4_rows(q, k, v, l, valid_len=n)
VARIANTS = {
    "v32_probe/v3.1": ("kernel_v32_probe", _J7(False), lambda q, k, v, l, n: pa.int4_rows(
        q, k, v, l, valid_len=n, unpack="byte"), "int4"),
    "v32_probe/v3.2": ("kernel_v32_probe", _J7(True), _EXACT, "int4"),
    "v32_probe/mxu": ("kernel_v32_probe", _J7("mxu"), lambda q, k, v, l, n: pa.int8_dot(
        q, k, v, l, valid_len=n), "int4"),
    **{f"v34_probe/{x}": ("kernel_v34_probe", _J8(x), lambda q, k, v, l, n, x=x: pa.int4_rows(
        q, k, v, l, valid_len=n, bb=BB, joint=x != "a"), "int4") for x in "abcde"},
    "v34_probe/s": ("kernel_v34_probe", _J8("s"), lambda q, k, v, l, n: pa.probe_stream(
        q, k, v, l, bb=BB), "int4"),
    "v34_probe/v32": ("kernel_v34_probe", lambda m, q, k, v, l, n: m._stacked_call_v32(
        q, k, v, l, valid_len=n), _EXACT, "int4"),
    "v4_probe/i8_f32": ("kernel_v4_probe", _J9("_kernel_i8_f32"),
                        lambda q, k, v, l, n: da.cross_attention_int8(q, k[l], v[l], valid_len=n),
                        "int8"),
    "v4_probe/i8_mxu_k": ("kernel_v4_probe", _J9("_kernel_i8_mxu_k"), lambda q, k, v, l, n:
                          pa.int8_dot(q, k, v, l, valid_len=n, cache="int8", pv="f32"), "int8"),
    "v4_probe/i8_mxu_kv": ("kernel_v4_probe", _J9("_kernel_i8_mxu_kv"), lambda q, k, v, l, n:
                           pa.int8_dot(q, k, v, l, valid_len=n, cache="int8"), "int8"),
    "v4_probe/i4_bf16": ("kernel_v4_probe", _J9("_kernel_i4_bf16"), lambda q, k, v, l, n:
                         pa.int4_rows(q, k, v, l, valid_len=n, bf16=True), "int4"),
    "v4_probe/i4_mxu_kv": ("kernel_v4_probe", _J9("_kernel_i4_mxu_kv"), lambda q, k, v, l, n:
                           pa.int8_dot(q, k, v, l, valid_len=n), "int4"),
}


@pytest.mark.parametrize("valid", [200, 201])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_variant_matches_jax_probe(probes, interpret, variant, valid):
    probe, jax_call, port_call, cache = VARIANTS[variant]
    q, k8, v8, k4, v4 = _inputs(valid)
    k, v = (k4, v4) if cache == "int4" else (k8, v8)
    want = np.asarray(jax_call(probes[probe], jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(1), valid))
    got = port_call(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 1, valid)
    assert got.shape == (B, 1, H, DH) and got.dtype == torch.float32
    if variant.endswith("/s"):  # the stream-only checksum, bit for bit
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


def test_quant_q_matches_both_jax_versions(probes):
    """kernel_v32_probe's _quant_q has no clip and kernel_v4_probe's clips to
    [-127, 127]; the clip never acts, so the port's one function equals both,
    rows of zeros, ties at .5 and a lone large value included."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(6, DH)).astype(np.float32)
    q[1] = 0.0
    q[2, :4] = [127.0, -0.5, 0.5, 1.5]  # scale 1: ties round to even
    q[3] *= 1e-9
    q8, sq = pa.quant_q(torch.from_numpy(q))
    for mod in ("kernel_v32_probe", "kernel_v4_probe"):
        j8, jsq = probes[mod]._quant_q(jnp.asarray(q))
        np.testing.assert_array_equal(q8.numpy(), np.asarray(j8))
        np.testing.assert_array_equal(sq.numpy(), np.asarray(jsq))
    assert q8.dtype == torch.int8 and q8[2, :4].tolist() == [127, 0, 0, 2]


@pytest.mark.parametrize("wrapper,kw", [
    (pa.probe_stream, {"bb": 2}),
    (pa.int4_rows, {"valid_len": 201, "unpack": "byte"}),
    (pa.int8_dot, {"valid_len": 201}),
])
def test_cpu_tensors_reach_the_plain_version(wrapper, kw):
    """A CPU tensor runs the plain version (no launch counted); a tensor on
    another device type raises before anything launches."""
    q, _, _, k4, v4 = _inputs(201)
    q, k4, v4 = torch.from_numpy(q), torch.from_numpy(k4), torch.from_numpy(v4)
    before = wrapper.launches
    out = wrapper(q, k4, v4, 1, **kw)
    assert wrapper.launches == before
    plain = {pa.probe_stream: lambda: pa.probe_stream_reference(q, k4, v4, 1),
             pa.int4_rows: lambda: pa.int4_rows_reference(q, k4, v4, 1, valid_len=201),
             pa.int8_dot: lambda: pa.int8_dot_reference(q, k4, v4, 1, valid_len=201)}[wrapper]()
    assert torch.equal(out, plain)
    with pytest.raises(ValueError):
        wrapper(q.to("meta"), k4.to("meta"), v4.to("meta"), 1, **kw)


def test_plain_int8_dot_rejects_an_unknown_cache():
    q, _, _, k4, v4 = _inputs(200)
    with pytest.raises(ValueError):
        pa.int8_dot(torch.from_numpy(q), torch.from_numpy(k4), torch.from_numpy(v4), 0,
                    valid_len=200, cache="int2")
