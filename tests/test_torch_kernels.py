"""The port's kernel wrappers against the JAX package on the CPU.

The Hopper kernels themselves run only on the card (``chip_smoke.py``
holds them against these plain versions there).  Here the plain versions
that the wrappers take for CPU tensors are held against the Pallas
kernels in interpret mode and the jnp oracles, on the same numpy inputs:
paged decode attention (K1), its quantized twin (K2) and RMSNorm (K3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixed_precision as jmp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models import modules as jmodules
from repro_torch.core import mixed_precision as tmp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

D = 32          # head dim
KVH = 2
N_TABLE = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _paged_case(seed, group, page):
    """Seats with lengths 1, an exact page multiple, a full table, and
    one ragged length; pages scattered over the pool."""
    rng = np.random.default_rng(seed)
    lengths = np.array([1, 2 * page, N_TABLE * page, page + page // 2 + 1],
                       np.int32)
    need = [-(-int(n) // page) for n in lengths]
    P = 1 + sum(need) + 3
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    table = np.zeros((len(lengths), N_TABLE), np.int32)
    at = 0
    for a, k in enumerate(need):
        table[a, :k] = perm[at:at + k]
        at += k
    H = KVH * group
    q = rng.normal(size=(len(lengths), 1, H, D)).astype(np.float32)
    k = rng.normal(size=(P, page, KVH, D)).astype(np.float32)
    v = rng.normal(size=(P, page, KVH, D)).astype(np.float32)
    return q, k, v, table, lengths


def _flat_ref_inputs(q, k, v, table, lengths, ks=None, vs=None):
    """The JAX ops wrapper's GQA expansion, for calling the oracles."""
    B, _, H, d = q.shape
    P, page, kvh, _ = k.shape
    rep = H // kvh
    kf = k.transpose(2, 0, 1, 3).reshape(kvh * P, page, d)
    vf = v.transpose(2, 0, 1, 3).reshape(kvh * P, page, d)
    base = (np.arange(H, dtype=np.int32) // rep) * P
    pt = (base[None, :, None] + table[:, None, :]).reshape(B * H, -1)
    out = [q[:, 0].reshape(B * H, d), kf, vf]
    if ks is not None:
        out += [ks.transpose(2, 0, 1).reshape(kvh * P, page),
                vs.transpose(2, 0, 1).reshape(kvh * P, page)]
    return out + [pt.astype(np.int32), np.repeat(lengths, H)]


# -- K1: paged decode attention ----------------------------------------------

@pytest.mark.parametrize("group", [1, 2, 4, 6])
@pytest.mark.parametrize("page", [4, 8, 16])
def test_paged_decode_plain_matches_pallas_and_oracle(group, page):
    q, k, v, table, lengths = _paged_case(group * 100 + page, group, page)
    want_pallas = np.asarray(jops.paged_decode_attention(
        q, k, v, table, lengths, interpret=True))
    flat = _flat_ref_inputs(q, k, v, table, lengths)
    want_ref = np.asarray(jref.paged_decode_attention_ref(*flat))
    got = tops.paged_decode_attention(_t(q), _t(k), _t(v), _t(table),
                                      _t(lengths), impl="plain").numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    # f32 throughout; sums taken in another order than XLA's
    np.testing.assert_allclose(got, want_pallas, atol=2e-6, rtol=0)
    np.testing.assert_allclose(got.reshape(-1, D), want_ref, atol=2e-6,
                               rtol=0)
    # the port's own oracle in the JAX layout agrees too
    tflat = [_t(a) for a in flat]
    np.testing.assert_allclose(
        tref.paged_decode_attention_ref(*tflat).numpy(), want_ref,
        atol=2e-6, rtol=0)


def test_decode_attention_ref_matches_jax_at_odd_lengths():
    rng = np.random.default_rng(5)
    for T in (37, 65, 100):
        q = rng.normal(size=(6, D)).astype(np.float32)
        k = rng.normal(size=(6, T, D)).astype(np.float32)
        v = rng.normal(size=(6, T, D)).astype(np.float32)
        lengths = rng.integers(1, T + 1, 6).astype(np.int32)
        want = np.asarray(jref.decode_attention_ref(q, k, v, lengths))
        got = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(lengths))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


# -- K2: quantized paged decode attention ------------------------------------

@pytest.mark.parametrize("kv_dtype", ["fp8", "int8"])
@pytest.mark.parametrize("group", [1, 2, 4, 6])
def test_quantized_paged_decode_plain_matches_pallas(kv_dtype, group):
    q, k, v, table, lengths = _paged_case(7 + group, group, 8)
    kq, ks = (np.asarray(a) for a in jmp.quantize_kv_page(k, kv_dtype))
    vq, vs = (np.asarray(a) for a in jmp.quantize_kv_page(v, kv_dtype))
    want = np.asarray(jops.paged_decode_attention(
        q, kq, vq, table, lengths, k_scale=ks, v_scale=vs, interpret=True))
    got = tops.paged_decode_attention(
        _t(q), _t(kq), _t(vq), _t(table), _t(lengths), k_scale=_t(ks),
        v_scale=_t(vs), impl="plain").numpy()
    # dequantized f32 values are exact in both; only the sum order differs
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    flat = _flat_ref_inputs(q, kq, vq, table, lengths, ks, vs)
    want_ref = np.asarray(jref.quantized_paged_decode_attention_ref(*flat))
    np.testing.assert_allclose(
        tref.quantized_paged_decode_attention_ref(
            *[_t(a) for a in flat]).numpy(), want_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["fp8", "int8"])
def test_quantize_kv_page_byte_equal(kv_dtype):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(5, 7, 3, D)).astype(np.float32)
    x[0, 0, 0] = 0.0                                 # all-zero vector
    x[1, 2] *= 1e4                                   # wide dynamic range
    x[2, 3, 1, :5] = [448.0, -448.0, 1e-8, 3.5, -0.0]
    jq, js = (np.asarray(a) for a in jmp.quantize_kv_page(x, kv_dtype))
    tq, ts = tmp.quantize_kv_page(_t(x), kv_dtype)
    assert tq.dtype == tmp.kv_storage_dtype(kv_dtype)
    assert tq.numpy().tobytes() == jq.tobytes()
    assert ts.numpy().view(np.uint32).tobytes() == js.view(np.uint32).tobytes()
    np.testing.assert_array_equal(
        tmp.dequantize_kv_page(tq, ts).numpy(),
        np.asarray(jmp.dequantize_kv_page(jq, js)))


def test_kv_precision_helpers_match_jax():
    for dt in tmp.KV_DTYPES:
        assert tmp.kv_is_quantized(dt) == jmp.kv_is_quantized(dt)
        assert tmp.kv_precision_bits(dt) == jmp.kv_precision_bits(dt)
        for hd in (16, 128):
            assert tmp.kv_token_bytes(dt, hd) == jmp.kv_token_bytes(dt, hd)
        assert (tmp.kv_storage_dtype(dt).itemsize
                == jnp.dtype(jmp.kv_storage_dtype(dt)).itemsize)
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        tmp.kv_storage_dtype("fp4")
    with pytest.raises(ValueError, match="quantized"):
        tmp.quantize_kv_page(torch.zeros(2, D), "bf16")


# -- K3: RMSNorm ---------------------------------------------------------------

@pytest.mark.parametrize("d", [128, 2048])
def test_rmsnorm_plain_matches_jax_f32(d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(9, d)).astype(np.float32) * 3.0
    w = rng.normal(size=(d,)).astype(np.float32) * 0.1
    got = tops.rmsnorm(_t(x), _t(w), impl="plain").numpy()
    for want in (jref.rmsnorm_ref(x, w), jmodules.rms_norm(x, w),
                 rmsnorm_pallas(x[:8], w, bm=8, interpret=True)):
        want = np.asarray(want)
        np.testing.assert_allclose(got[:len(want)], want, atol=1e-6, rtol=0)


def test_rmsnorm_plain_matches_jax_bf16_within_one_ulp():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 2048)).astype(np.float32) * 2.0
    w = rng.normal(size=(2048,)).astype(np.float32) * 0.1
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = _t(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(jx).view(np.uint16),
                          tx.view(torch.int16).numpy().view(np.uint16))
    want = np.asarray(jmodules.rms_norm(jx, w)).view(np.uint16).astype(
        np.int32)
    got = tops.rmsnorm(tx, _t(w), impl="plain").view(torch.int16).numpy()
    got = got.view(np.uint16).astype(np.int32)
    # same sign everywhere, so the bit patterns' distance counts ulps;
    # XLA and torch round the f32 result to bf16 from sums taken in
    # another order
    assert np.abs(got - want).max() <= 1


# -- dispatch ------------------------------------------------------------------

def test_auto_takes_plain_on_cpu_and_counts_no_launch():
    tops.reset_launches()
    q, k, v, table, lengths = _paged_case(1, 2, 4)
    args = [_t(a) for a in (q, k, v, table, lengths)]
    auto = tops.paged_decode_attention(*args)
    plain = tops.paged_decode_attention(*args, impl="plain")
    assert torch.equal(auto, plain)
    x = torch.randn(4, 64)
    assert torch.equal(tops.rmsnorm(x, torch.zeros(64)),
                       tops.rmsnorm(x, torch.zeros(64), impl="plain"))
    assert all(n == 0 for n in tops.launches.values())


def test_launch_counts_are_kept_per_pool_type_and_width(monkeypatch):
    """Each kernel launch counts under its variant.  The kernels need the
    card, so the launch points are stood in for by the plain versions and
    the wrappers are made to take the kernel branch."""
    import contextlib
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import rmsnorm as trn

    def attn(q, k, v, table, lengths, ks, vs, out, window=None):
        out.copy_(tda.paged_decode_attention_plain(q, k, v, table, lengths,
                                                   ks, vs, window))

    def norm(x, w, out, eps):
        out.copy_(trn.rmsnorm_plain(x, w, eps=eps))

    monkeypatch.setattr(tops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tda, "paged_decode_attention_cuda", attn)
    monkeypatch.setattr(trn, "rmsnorm_triton", norm)
    tops.reset_launches()
    q, k, v, table, lengths = (_t(a) for a in _paged_case(2, 2, 4))
    tops.paged_decode_attention(q, k, v, table, lengths)
    tops.paged_decode_attention(q, k.bfloat16(), v.bfloat16(), table,
                                lengths)
    for dt in ("fp8", "int8", "int8"):
        (kq, ks), (vq, vs) = (tmp.quantize_kv_page(k, dt),
                              tmp.quantize_kv_page(v, dt))
        tops.paged_decode_attention(q, kq, vq, table, lengths, k_scale=ks,
                                    v_scale=vs)
    tops.paged_decode_attention(q, kq, vq, table, lengths, k_scale=ks,
                                v_scale=vs, window=3)
    for d in (64, 64, 16):
        tops.rmsnorm(torch.randn(3, d), torch.zeros(d))
    assert dict(tops.launches) == {
        "paged_decode_attention[f32]": 1, "paged_decode_attention[bf16]": 1,
        "quantized_paged_decode_attention[fp8]": 1,
        "quantized_paged_decode_attention[int8]": 2,
        "quantized_paged_decode_attention[int8,window]": 1,
        "rmsnorm[D=64]": 2, "rmsnorm[D=16]": 1}
    tops.reset_launches()
    assert tops.launches["rmsnorm[D=64]"] == 0 and not tops.launches


def test_kernel_impl_refuses_cpu_tensors_and_bad_args():
    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tops.rmsnorm(x, torch.zeros(64), impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.rmsnorm(x, torch.zeros(64), impl="pallas")
    q, k, v, table, lengths = _paged_case(2, 1, 4)
    args = [_t(a) for a in (q, k, v, table, lengths)]
    with pytest.raises(ValueError, match="together"):
        tops.paged_decode_attention(*args, k_scale=torch.ones(1))
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_decode_attention(*args, impl="kernel")


def test_build_all_keeps_each_report_beside_its_library(monkeypatch,
                                                        tmp_path):
    """A library built by an earlier run reports what its compile did
    (the spill check reads it every run); a library without its report
    is built again.  A stand-in compiler writes the libraries here."""
    import sys

    from repro_torch.kernels import _build
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc.py"
    fake.write_text(
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').close()\n"
        f"open({str(calls)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "print('ptxas info : 0 bytes spill stores, 0 bytes spill loads', "
        "sys.argv[-1])\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (str(fake),) + _build.NVCC_FLAGS)
    first = _build.build_all()
    assert set(first) == set(_build.SIGNATURES)
    assert all("0 bytes spill" in t and f"{n}.cu" in t
               for n, t in first.items())
    assert len(calls.read_text().splitlines()) == len(_build.SIGNATURES)
    assert _build.build_all() == first          # cached: no compile
    assert len(calls.read_text().splitlines()) == len(_build.SIGNATURES)
    _build._log_path("fp8_matmul").unlink()
    assert _build.build_all() == first
    assert calls.read_text().splitlines()[-1].endswith("fp8_matmul.cu")
    assert len(calls.read_text().splitlines()) == len(_build.SIGNATURES) + 1
