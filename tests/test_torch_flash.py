"""P4 flash attention in the port against the JAX package, on the CPU.

The JAX side runs ``flash_or_xla_attention(..., use_flash=True)``, which
calls the stock Pallas TPU flash attention, in interpret mode
(``pltpu.force_tpu_interpret_mode``), forward and custom VJP; the port's
side runs its plain versions, as every wrapper does on CPU tensors.
Inputs are ``[2, 128, 2, 16]`` (``[B, S, H, D]``) from a numpy seed: the
stock kernel needs S to be a multiple of 128.  The forward's statistics m
and l are held against the stock kernel's residuals at S 256.
Tolerances: float32 atol 1e-5 (the same arithmetic summed in another
order); bfloat16 atol 2e-2 (one rounding of p, ds and the outputs to
bfloat16, at other places).  The float32 forward kernel runs its products
in three tf32 passes on the tensor cores (3xTF32); a torch emulation of
that arithmetic is held against the stock kernel here, at the float32
limit, beside one tf32 pass, which misses it.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as stock_flash

from deepchem_tpu.models.bert_encoder import \
    flash_or_xla_attention as jax_attention
from deepchem_tpu_torch.models.bert_encoder import flash_or_xla_attention
from deepchem_tpu_torch.ops.flash_attention import (
    _forward_reference, flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_forward,
    flash_attention_reference)

# the module, which the package's function of the same name shadows
flash_ops = importlib.import_module('deepchem_tpu_torch.ops.flash_attention')

torch.set_num_threads(1)

TYPES = {'float32': (jnp.float32, torch.float32, 1e-5),
         'bfloat16': (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, S, H, D, seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(n)]


def _port(arrays, dtype, **kw):
    """The port's entry point on CPU tensors: output and the gradients of
    ``sum(out * w)`` for q, k and v, as float32 numpy arrays."""
    q, k, v, w = arrays
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = flash_or_xla_attention(*ts, **kw)
    (out.float() * torch.from_numpy(w).to(dtype).float()).sum().backward()
    return [t.detach().float().numpy() for t in [out] + [t.grad for t in ts]]


@pytest.mark.parametrize('name', sorted(TYPES))
def test_flash_route_matches_the_stock_kernel(name):
    """Forward and gradients of the flash route against the stock kernel
    and its custom VJP in interpret mode."""
    jdt, tdt, atol = TYPES[name]
    arrays = _inputs(2, 128, 2, 16)
    q, k, v, w = (jnp.asarray(a, jdt) for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda a, b, c: jax_attention(a, b, c, None, use_flash=True),
            q, k, v)
        ref = [out] + list(vjp(w))
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    ours = _port(arrays, tdt, mask=None, use_flash=True)
    for what, a, b in zip(('out', 'dq', 'dk', 'dv'), ours, ref):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=what)


@pytest.mark.parametrize('name', sorted(TYPES))
def test_forward_statistics_match_the_stock_residuals(name):
    """The plain forward's ``(o, m, l)``, which the forward kernel must
    keep, against the stock kernel's output and residuals
    (``_flash_attention_impl(..., save_residuals=True)``, interpret mode)
    over two 128-key blocks, so the stock kernel rescales once: ``m`` the
    row max of ``s * sm_scale`` and ``l`` the sum of ``exp(s * sm_scale -
    m)``, each within the type's tolerance of max(1, |ref|)."""
    jdt, tdt, atol = TYPES[name]
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
               for a in _inputs(1, 256, 2, 32, seed=5, n=3))
    scale = 32 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref = stock_flash._flash_attention_impl(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), None, None, True,
            False, scale, 1, 128, 128, 128, False)
    ref_o, ref_l, ref_m = (np.asarray(r.astype(jnp.float32)) for r in ref)
    o, m, l = flash_attention_forward(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), scale)
    assert o.dtype == tdt and m.dtype == l.dtype == torch.float32
    for what, a, b in (('o', o, ref_o), ('m', m, ref_m), ('l', l, ref_l)):
        np.testing.assert_allclose(a.float().numpy(), b,
                                   atol=atol * max(1.0, np.abs(b).max()),
                                   err_msg=what)


@pytest.mark.parametrize('masked', [False, True])
def test_einsum_route_matches_jax(masked):
    """The default route, with and without a padding mask, against the
    JAX package's ``use_flash=False``; float32."""
    q, k, v, w = _inputs(2, 12, 3, 8, seed=1)
    mask = None
    if masked:
        mask = np.ones((2, 12), np.float32)
        mask[0, 7:] = 0
        mask[1, 3:] = 0
    jmask = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, jmask),
                       *(jnp.asarray(a) for a in (q, k, v)))
    ref = [np.asarray(r) for r in [out] + list(vjp(jnp.asarray(w)))]
    ours = _port((q, k, v, w), torch.float32,
                 mask=None if mask is None else torch.from_numpy(mask))
    for what, a, b in zip(('out', 'dq', 'dk', 'dv'), ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=what)


def test_flash_route_ignores_the_mask():
    """As in the JAX package: the flash route attends everywhere whatever
    the mask says."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 20, 2, 8, n=3))
    mask = torch.ones(2, 20)
    mask[:, 10:] = 0
    with_mask = flash_or_xla_attention(q, k, v, mask, use_flash=True)
    assert torch.equal(with_mask,
                       flash_or_xla_attention(q, k, v, None, use_flash=True))
    np.testing.assert_allclose(
        with_mask.numpy(), flash_or_xla_attention(q, k, v, None).numpy(),
        atol=1e-6)


@pytest.mark.parametrize('name', sorted(TYPES))
def test_unaligned_length_matches_the_einsum_route(name):
    """S = 200, which the stock kernel refuses (a TPU block limit): the
    flash route's plain versions against autograd through the einsum
    route, both in float32 from the same (rounded) inputs."""
    _, tdt, atol = TYPES[name]
    arrays = [torch.from_numpy(a).to(tdt).float().numpy()
              for a in _inputs(1, 200, 2, 32, seed=2)]
    flash = _port(arrays, tdt, mask=None, use_flash=True)
    einsum = _port(arrays, torch.float32, mask=None)
    for what, a, b in zip(('out', 'dq', 'dk', 'dv'), flash, einsum):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=what)


def test_backward_equals_autograd_through_the_plain_forward():
    """The plain dK/dV and dQ versions (the stock VJP's formulas) against
    torch autograd through :func:`flash_attention_reference`; float32,
    [B, H, S, D]."""
    q, k, v, w = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  for a in _inputs(2, 37, 3, 32, seed=3))
    grads = []
    for fn in (flash_attention, flash_attention_reference):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*ts, 0.3) * w).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    o, m, l = _forward_reference(q, k, v, 0.3)
    s = torch.matmul(q, k.transpose(-1, -2)) * 0.3
    np.testing.assert_allclose(m.numpy(), s.amax(-1).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        l.numpy(), torch.exp(s - m[..., None]).sum(-1).numpy(), rtol=1e-6)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, at 10 stored mantissa bits (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """``x`` truncated to tf32: the low 13 bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """``a @ b`` as the kernel's mma.sync computes it: one tf32 pass, or
    three (3xTF32: ``a = a_big + a_small``, ``b`` likewise, big rounded to
    tf32 and small, ``a - a_big``, truncated to it, ``a_small b_small``
    dropped; the small terms first)."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    a_small, b_small = _tf32_truncate(a - ab), _tf32_truncate(b - bb)
    return a_small @ bb + ab @ b_small + ab @ bb


def _tf32_forward(q, k, v, sm_scale, passes):
    """The float32 forward kernel's arithmetic on ``[B, H, S, D]``: s = q
    kᵀ, p = exp(s · sm_scale - m) unnormalised, o = (p v) / l, both
    products in ``passes`` tf32 passes."""
    s = _tf32_matmul(q, k.transpose(-1, -2), passes) * sm_scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _tf32_matmul(p, v, passes) / p.sum(-1, keepdim=True)


@functools.lru_cache(maxsize=None)
def _stock_f32(S):
    """Inputs ``[1, 2, S, 64]`` (``[B, H, S, D]``) from a numpy seed and the
    stock kernel's float32 output on them, in interpret mode."""
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
               for a in _inputs(1, S, 2, 64, seed=6, n=3))
    with pltpu.force_tpu_interpret_mode():
        ref = stock_flash.flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), sm_scale=64 ** -0.5)
    return q, k, v, np.asarray(ref)


@pytest.mark.parametrize('S', [128, 256])
def test_3xtf32_forward_keeps_the_float32_limit(S):
    """The f32 forward kernel's arithmetic (three tf32 passes) against the
    stock kernel in float32: within FLASH_TOL's 1e-5 of max(1, |ref|)."""
    q, k, v, ref = _stock_f32(S)
    o = _tf32_forward(*(torch.from_numpy(a) for a in (q, k, v)), 64 ** -0.5,
                      passes=3).numpy()
    tol = TYPES['float32'][2] * max(1.0, np.abs(ref).max())
    assert np.abs(o - ref).max() <= tol


@pytest.mark.parametrize('S', [128, 256])
def test_one_tf32_pass_misses_the_float32_limit(S):
    """The control: one tf32 pass, about 11 significant bits, misses the
    same limit by far."""
    q, k, v, ref = _stock_f32(S)
    o = _tf32_forward(*(torch.from_numpy(a) for a in (q, k, v)), 64 ** -0.5,
                      passes=1).numpy()
    tol = TYPES['float32'][2] * max(1.0, np.abs(ref).max())
    assert np.abs(o - ref).max() > 10 * tol


def test_tf32_rounding_is_to_nearest_ties_away():
    """``_tf32`` and ``_tf32_truncate`` against exact cases around tf32's
    ulp of 2^-10 at 1."""
    x = torch.tensor([1 + 2**-11, 1 + 2**-11 + 2**-20, 1 + 3 * 2**-11,
                      -(1 + 2**-11), 1 + 2**-12, 3.0], dtype=torch.float32)
    want = [1 + 2**-10, 1 + 2**-10, 1 + 2 * 2**-10, -(1 + 2**-10), 1.0, 3.0]
    assert _tf32(x).tolist() == want
    assert _tf32_truncate(x).tolist() == [1.0, 1.0, 1 + 2**-10, -1.0, 1.0,
                                          3.0]


def test_cpu_wrappers_launch_nothing():
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2).contiguous()
                   for a in _inputs(1, 16, 2, 8, seed=4))
    counters = (flash_attention, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)
    before = [c.launches for c in counters]
    o, m, l = flash_attention_forward(q, k, v, 0.5)
    di = (o * do).sum(-1)
    flash_attention_bwd_dkv(q, k, v, do, m, l, di, 0.5)
    flash_attention_bwd_dq(q, k, v, do, m, l, di, 0.5)
    x = q.clone().requires_grad_()
    flash_attention(x, k, v, 0.5).sum().backward()
    assert [c.launches for c in counters] == before


class _PosedCuda:
    """A stand-in for a CUDA tensor, for the wrapper's checks: it has the
    shape, type, layout and an aligned address of ``t``."""

    def __init__(self, t, device='cuda:0'):
        self.t, self.device = t, torch.device(device)
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return 256

    def numel(self):
        return self.t.numel()


def test_cuda_checks_raise_on_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 16, 64)
    qkv = [_PosedCuda(q)] * 3
    cases = [
        (TypeError, [_PosedCuda(q.double())] + qkv[1:]),
        (TypeError, [_PosedCuda(q.half())] * 3),
        (TypeError, qkv[:2] + [_PosedCuda(q.bfloat16())]),
        (ValueError, qkv[:2] + [_PosedCuda(q, 'cpu')]),
        (ValueError, qkv[:2] + [_PosedCuda(torch.zeros(1, 2, 8, 64))]),
        (ValueError, [_PosedCuda(torch.zeros(1, 2, 16, 48))] * 3),
        (ValueError,
         [_PosedCuda(torch.zeros(1, 2, 64, 16).transpose(2, 3))] * 3),
    ]
    flash_ops._check('flash_attention', tuple(qkv))      # what it takes
    for err, args in cases:
        with pytest.raises(err):
            flash_ops._check('flash_attention', tuple(args))
    stats = _PosedCuda(torch.zeros(1, 2, 16))
    flash_ops._check('flash_attention_bwd_dq', tuple(qkv) * 2, (stats,) * 3)
    with pytest.raises(TypeError):
        flash_ops._check('flash_attention_bwd_dq', tuple(qkv) * 2,
                         (_PosedCuda(torch.zeros(1, 2, 16).bfloat16()),
                          stats, stats))
    with pytest.raises(ValueError):
        flash_ops._check('flash_attention_bwd_dq', tuple(qkv) * 2,
                         (_PosedCuda(torch.zeros(1, 2, 15)), stats, stats))
    # a tensor that is on neither the CPU nor a CUDA device
    meta = torch.zeros(1, 2, 16, 64, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        flash_attention_forward(meta, meta, meta, 0.125)
