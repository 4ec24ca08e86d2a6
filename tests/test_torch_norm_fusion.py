"""K3's fused forms against the JAX package on the CPU, and the model's
use of them.

``add_rmsnorm`` (a residual add and the RMSNorm that reads its result)
and ``rmsnorm_qk`` (attention's q-norm and k-norm in one launch) run as
Triton kernels on the card, where ``chip_smoke.py`` holds them against
their plain versions.  Here the plain versions are held against the JAX
package on the same numpy inputs: ``x + y`` bit-equal to jnp's add, the
norms within the one-ulp bf16 rule of
``test_torch_kernels.py::test_rmsnorm_plain_matches_jax_bf16_within_one_ulp``
(f32: 1e-6).  The model's paths must stay bit-identical to the unfused
composition they replace, and must call each fused op as often as the
layer count says.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models import modules as jmodules
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as M
from repro_torch.models.modules import init_params, swiglu


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """The bit patterns of a bf16 or f32 tensor or array, as int64."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
        return x.numpy().astype(np.int64)
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.name == "bfloat16"
                  else np.int32).astype(np.int64)


def _rows(rng, shape, dtype, scale=2.0):
    x = rng.normal(size=shape).astype(np.float32) * scale
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _held(got, want, dtype):
    """bf16: at most one ulp apart (the sign is the same, so the bit
    patterns' distance counts ulps: XLA and torch take the f32 sums in
    another order before the one rounding); f32: within 1e-6."""
    if dtype == "bf16":
        assert np.abs(_bits(got) - _bits(want)).max() <= 1
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


# -- the plain versions against JAX ----------------------------------------

@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("d", [128, 2048])
def test_add_rmsnorm_plain_matches_jax(d, dtype):
    rng = np.random.default_rng(d + len(dtype))
    x, y = _rows(rng, (16, d), dtype), _rows(rng, (16, d), dtype, 0.5)
    w = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    s, n = ops.add_rmsnorm(_t(x), _t(y), _t(w), impl="plain")
    js = x + y                                  # the JAX model's residual
    assert np.array_equal(_bits(s), _bits(js))  # bit-equal
    _held(n, jmodules.rms_norm(js, w), dtype)
    # the Pallas kernel reads f32 rows: the norm of the rounded sum
    want = rmsnorm_pallas(jnp.asarray(js, jnp.float32), w, bm=8,
                          interpret=True)
    _held(n, jnp.asarray(want, js.dtype), dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_rmsnorm_qk_plain_matches_two_jax_norms(dtype):
    rng = np.random.default_rng(7)
    q, k = _rows(rng, (3, 5, 8, 64), dtype), _rows(rng, (3, 5, 2, 64), dtype)
    wq, wk = ((rng.normal(size=(64,)) * 0.1).astype(np.float32)
              for _ in range(2))
    qn, kn = ops.rmsnorm_qk(_t(q), _t(k), _t(wq), _t(wk), impl="plain")
    assert qn.shape == q.shape and kn.shape == k.shape
    _held(qn, jmodules.rms_norm(q, wq), dtype)
    _held(kn, jmodules.rms_norm(k, wk), dtype)
    # each row set with its own weight: swapping the weights is seen
    swapped, _ = ops.rmsnorm_qk(_t(q), _t(k), _t(wk), _t(wq), impl="plain")
    assert not torch.equal(swapped, qn)


# -- the wrappers' kernel branch --------------------------------------------

@pytest.fixture
def kernel_branch(monkeypatch):
    """The wrappers made to take the kernel branch on the CPU, the Triton
    launches stood in for by the plain versions."""
    def add_norm(x, y, w, s, out, eps):
        ps, pn = rn.add_rmsnorm_plain(x, y, w, eps=eps)
        s.copy_(ps)
        out.copy_(pn)

    def qk_norm(q, k, wq, wk, q_out, k_out, eps):
        pq, pk = rn.rmsnorm_qk_plain(q, k, wq, wk, eps=eps)
        q_out.copy_(pq)
        k_out.copy_(pk)

    def norm(x, w, out, eps):
        out.copy_(rn.rmsnorm_plain(x, w, eps=eps))

    monkeypatch.setattr(ops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(rn, "add_rmsnorm_triton", add_norm)
    monkeypatch.setattr(rn, "rmsnorm_qk_triton", qk_norm)
    monkeypatch.setattr(rn, "rmsnorm_triton", norm)
    ops.reset_launches()
    yield
    ops.reset_launches()


def test_fused_norm_launches_count_by_width(kernel_branch):
    x, y = torch.randn(2, 3, 64).bfloat16(), torch.randn(2, 3, 64).bfloat16()
    w = torch.randn(64)
    s, n = ops.add_rmsnorm(x, y, w)
    assert s.shape == n.shape == x.shape
    assert torch.equal(s, x + y) and torch.equal(n, ops.rmsnorm(x + y, w))
    q, k = torch.randn(2, 1, 4, 16), torch.randn(2, 1, 2, 16)
    for _ in range(2):
        qn, kn = ops.rmsnorm_qk(q, k, torch.zeros(16), torch.ones(16))
    assert torch.equal(qn, rn.rmsnorm_plain(q, torch.zeros(16)))
    assert torch.equal(kn, rn.rmsnorm_plain(k, torch.ones(16)))
    assert dict(ops.launches) == {"add_rmsnorm[D=64]": 1, "rmsnorm[D=64]": 1,
                                  "rmsnorm_qk[D=16]": 2}


def test_fused_norm_kernel_branch_refuses_what_it_cannot_take(kernel_branch):
    x = torch.randn(4, 64).bfloat16()
    w = torch.zeros(64)
    with pytest.raises(ValueError, match="match x"):
        ops.add_rmsnorm(x, x.float(), w)
    with pytest.raises(ValueError, match="match x"):
        ops.add_rmsnorm(x, x[:2], w)
    with pytest.raises(ValueError, match="w shape"):
        ops.add_rmsnorm(x, x, torch.zeros(32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.add_rmsnorm(x.t().contiguous().t(), x, w)
    q, k = torch.randn(2, 4, 16), torch.randn(2, 2, 16)
    with pytest.raises(ValueError, match="does not match q"):
        ops.rmsnorm_qk(q, k.bfloat16(), torch.zeros(16), torch.zeros(16))
    with pytest.raises(ValueError, match="w shape"):
        ops.rmsnorm_qk(q, k, torch.zeros(16), torch.zeros(8))
    assert not ops.launches


def test_kernel_impl_of_the_fused_norms_refuses_cpu_tensors():
    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.add_rmsnorm(x, x, torch.zeros(64), impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm_qk(x, x, torch.zeros(64), torch.zeros(64),
                       impl="kernel")


# -- the model -------------------------------------------------------------

def _model(dtype="bfloat16"):
    cfg = reduced_config(get_config("qwen3-1.7b"), compute_dtype=dtype)
    params = init_params(M.param_specs(cfg), torch.Generator().manual_seed(0))
    return cfg, params


def _unfused_stream(params, cfg, x, mixer):
    """The composition the model had before the fusion: each norm alone,
    each residual add its own op."""
    eps = cfg.norm_eps
    for g, i, kind, p in M._layers(params, cfg):
        h = ops.rmsnorm(x, p["ln1"], eps=eps)
        x = x + mixer(g, i, kind, p, h)
        h = ops.rmsnorm(x, p["ln2"], eps=eps)
        x = x + swiglu(h, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"],
                       x.dtype)
    return ops.rmsnorm(x, params["final_norm"], eps=eps)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_residual_stream_is_bit_identical_to_the_unfused_composition(dtype):
    cfg, params = _model(dtype)
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(M.compute_dtype(cfg))

    def mixer(g, i, kind, p, h):
        return attn_mod.attention(p["mixer"], cfg, h, kind=kind)[0]
    fused, _ = M._residual_stream(params, cfg, x, mixer, impl="auto")
    assert torch.equal(fused, _unfused_stream(params, cfg, x, mixer))


class _Counts:
    """Counts the model's calls of the norm ops (on the CPU nothing
    launches, so ``ops.launches`` stays empty)."""

    def __init__(self, monkeypatch):
        self.n = {"rmsnorm": 0, "add_rmsnorm": 0, "rmsnorm_qk": 0}
        for name in self.n:
            monkeypatch.setattr(ops, name, self._counted(name,
                                                         getattr(ops, name)))

    def _counted(self, name, fn):
        def call(*args, **kw):
            self.n[name] += 1
            return fn(*args, **kw)
        return call


@pytest.mark.parametrize("path", ["paged_tick", "decode_step", "prefill"])
def test_each_layer_calls_two_fused_adds_and_one_qk_norm(path, monkeypatch):
    cfg, params = _model()
    assert cfg.qk_norm
    L = cfg.num_layers
    A = 2
    tok = torch.tensor([3, 7], dtype=torch.int32)
    counts = _Counts(monkeypatch)
    if path == "paged_tick":
        cache = M.init_paged_cache(cfg, 5, 4)
        table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        zeros = torch.zeros(A, dtype=torch.int64)
        M.fused_decode_tick(params, cfg, cache, tok.clone(),
                            torch.tensor([2, 5], dtype=torch.int32), table,
                            torch.ones(A, dtype=torch.int32), torch.zeros(A),
                            torch.zeros(A, dtype=torch.int32), torch.ones(A),
                            zeros, zeros, zeros)
    elif path == "decode_step":
        M.decode_step(params, cfg, M.init_cache(cfg, A, 8), tok[:, None],
                      torch.tensor([2, 7], dtype=torch.int32))
    else:
        M.prefill(params, cfg, {"tokens": torch.randint(0, cfg.vocab_size,
                                                        (A, 6))})
    assert counts.n == {"rmsnorm": 1, "add_rmsnorm": 2 * L, "rmsnorm_qk": L}
