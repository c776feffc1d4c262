"""Tests of the port that need a CUDA device: each CUDA kernel against its
plain PyTorch version on the card (P1 and P3 also on segments long enough
to be split across a block), P1's backward against autograd through its plain
version, one PAGTN training step against the CPU, P4's forward (with its
statistics m and l) and backward kernels against the plain flash
attention (the float32 backward also against its formulas in float64),
and the encoder's logits against the CPU.  They skip where
there is no GPU.  This file imports no JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from deepchem_tpu_torch import (BertEncoderMLM, PagtnModel,
                                PagtnMolGraphFeaturizer)
from deepchem_tpu_torch.ops import NEG
from deepchem_tpu_torch.ops.csr_segment import (
    csr_neighbor_sum_reference, csr_segment_softmax,
    csr_segment_softmax_reference, csr_segment_sum,
    csr_segment_sum_reference, edges_to_csr, fused_gather_segment_sum)
from deepchem_tpu_torch.ops.flash_attention import (
    _forward_reference, flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_forward,
    flash_attention_reference)

# same f32 inputs, summed in another order
ATOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('N,E,H', [(64, 300, 4), (512, 6144, 1),
                                   (2048, 16384, 8), (7, 0, 1)])
def test_csr_segment_softmax_kernel_matches_plain_version(cuda, N, E, H):
    rng = np.random.RandomState(N + E + H)
    perm, row_ptr = edges_to_csr(rng.randint(0, N, E), N)
    logits = torch.from_numpy(rng.randn(E, H).astype(np.float32)[perm])
    row_ptr = torch.from_numpy(row_ptr)
    before = csr_segment_softmax.launches
    y = csr_segment_softmax(logits.to(cuda), row_ptr.to(cuda))
    torch.cuda.synchronize()
    assert csr_segment_softmax.launches == before + (1 if E else 0)
    np.testing.assert_allclose(
        y.cpu().numpy(),
        csr_segment_softmax_reference(logits, row_ptr).numpy(), atol=ATOL)


# kSplitEdges in csrc/csr_segment_softmax.cu and csrc/csr_segment_sum.cu:
# longer segments are split across the kernel's block of 8 warps
SPLIT_EDGES = 128


def _long_softmax_case(name):
    """``(lengths, H, fill)`` of a P1 case with long segments; ``fill``
    edits the logits of the case's longest segment."""
    def all_neg(x):
        x[:] = NEG

    def head_neg_inf(x):
        x[:, -1] = -np.inf
    short = list(np.random.RandomState(0).randint(0, 34, 300))
    return {'ghost_1536_H1': (short + [1536], 1, None),
            'ghost_1536_H4': (short + [1536], 4, None),
            'segment_5000_H1': ([3, 5000, 0, 7], 1, None),
            'split_edges_pm1_H1': ([SPLIT_EDGES - 1, SPLIT_EDGES,
                                    SPLIT_EDGES + 1, 2, SPLIT_EDGES + 1,
                                    0], 1, None),
            'split_edges_pm1_H4': ([SPLIT_EDGES + 1, SPLIT_EDGES, 0,
                                    SPLIT_EDGES - 1], 4, None),
            'all_neg_2000_H2': ([5, 2000, 9], 2, all_neg),
            'head_neg_inf_2000_H4': ([11, 2000, 0], 4, head_neg_inf),
            'segment_40000_H1': ([7] * 511 + [40000], 1, None)}[name]


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['ghost_1536_H1', 'ghost_1536_H4',
                                  'segment_5000_H1', 'split_edges_pm1_H1',
                                  'split_edges_pm1_H4', 'all_neg_2000_H2',
                                  'head_neg_inf_2000_H4', 'segment_40000_H1'])
def test_csr_segment_softmax_long_segments_match_plain_version(cuda, name):
    """Segments around the split threshold, a ghost-like segment of 1.5k
    edges among short ones, 5k and 40k edges, a long all-NEG segment
    (1/count) and a long one with a head all -inf (0): within 1e-6 of the
    plain version and bit for bit the same on a repeat.  The plain version
    runs in float64 here: in float32 it sums a segment's exponentials in
    one accumulator, and where one logit dominates a long segment its sum
    drops the small terms, 2e-6 to 5e-5 off on these cases, while the
    kernel sums by lanes and warps first."""
    lengths, H, fill = _long_softmax_case(name)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    logits = np.random.RandomState(len(lengths) + H).randn(
        int(row_ptr[-1]), H).astype(np.float32) * 5
    if fill is not None:
        longest = int(np.argmax(lengths))
        fill(logits[row_ptr[longest]:row_ptr[longest + 1]])
    logits, row_ptr = (torch.from_numpy(a).to(cuda) for a in (logits,
                                                               row_ptr))
    before = csr_segment_softmax.launches
    y = csr_segment_softmax(logits, row_ptr)
    again = csr_segment_softmax(logits, row_ptr)
    torch.cuda.synchronize()
    assert csr_segment_softmax.launches == before + 2
    assert torch.equal(y, again)              # no atomics: bit for bit
    np.testing.assert_allclose(
        y.cpu().numpy(),
        csr_segment_softmax_reference(logits.double(), row_ptr).cpu().numpy(),
        atol=ATOL)
    if fill is not None:
        longest = int(np.argmax(lengths))
        part = y[row_ptr[longest]:row_ptr[longest + 1]].cpu().numpy()
        if name.startswith('all_neg'):
            np.testing.assert_allclose(part, 1 / lengths[longest],
                                       atol=ATOL)
        else:
            assert np.all(part[:, -1] == 0)


@pytest.mark.cuda
def test_csr_segment_softmax_rejects_what_the_kernel_does_not_take(cuda):
    logits = torch.zeros(8, 2, device=cuda)
    row_ptr = torch.tensor([0, 8], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        csr_segment_softmax(logits.double(), row_ptr)
    with pytest.raises(TypeError):
        csr_segment_softmax(logits, row_ptr.long())
    with pytest.raises(ValueError):
        csr_segment_softmax(logits.T, row_ptr)
    with pytest.raises(ValueError):
        csr_segment_softmax(logits, row_ptr.cpu())


def _close(out, ref):
    """Sums in another order: within 1e-5 of the largest magnitude."""
    ref = ref.cpu().numpy()
    np.testing.assert_allclose(out.cpu().numpy(), ref,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max(
                                   initial=0.0))))


@pytest.mark.cuda
@pytest.mark.parametrize('N,E,F', [(512, 6144, 32), (512, 6144, 1),
                                   (64, 300, 37), (64, 300, 3),
                                   (2048, 16384, 512), (7, 0, 4)])
def test_csr_segment_sum_kernel_matches_plain_version(cuda, N, E, F):
    rng = np.random.RandomState(N + E + F)
    perm, row_ptr = edges_to_csr(rng.randint(0, N - 2, E), N)  # empty tail
    msgs = torch.from_numpy(rng.randn(E, F).astype(np.float32)).to(cuda)
    row_ptr = torch.from_numpy(row_ptr).to(cuda)
    before = csr_segment_sum.launches
    out = csr_segment_sum(msgs, row_ptr)
    again = csr_segment_sum(msgs, row_ptr)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 2
    assert torch.equal(out, again)            # no atomics: bit for bit
    _close(out, csr_segment_sum_reference(msgs, row_ptr))


@pytest.mark.cuda
@pytest.mark.parametrize('F', [32, 1, 37, 512])
def test_csr_segment_sum_long_segments_match_plain_version(cuda, F):
    """Segments around the split threshold, several long ones in one block,
    a ghost-like segment of 1.5k edges and one of 40k, each sum bit for
    bit the same on a repeat."""
    lengths = [0, 3, SPLIT_EDGES - 1, SPLIT_EDGES, SPLIT_EDGES + 1, 5,
               SPLIT_EDGES + 7, 2 * SPLIT_EDGES, 1, 0, 8 * SPLIT_EDGES + 3,
               1536, 2, 40000]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    rng = np.random.RandomState(F)
    msgs = torch.from_numpy(rng.randn(int(row_ptr[-1]), F).astype(
        np.float32)).to(cuda)
    row_ptr = torch.from_numpy(row_ptr).to(cuda)
    before = csr_segment_sum.launches
    out = csr_segment_sum(msgs, row_ptr)
    again = csr_segment_sum(msgs, row_ptr)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 2
    assert torch.equal(out, again)            # no atomics: bit for bit
    _close(out, csr_segment_sum_reference(msgs, row_ptr))
    assert torch.all(out[[0, 9]] == 0)


@pytest.mark.cuda
def test_csr_segment_sum_unaligned_rows_and_a_short_row_ptr(cuda):
    """A view 4 bytes off 16-byte alignment takes the scalar path; edges
    past row_ptr[N] are ignored."""
    rng = np.random.RandomState(3)
    flat = torch.from_numpy(rng.randn(200 * 8 + 1).astype(np.float32))
    msgs = flat.to(cuda)[1:].view(200, 8)
    row_ptr = torch.tensor([0, 50, 50, 51, 180], dtype=torch.int32,
                           device=cuda)
    _close(csr_segment_sum(msgs, row_ptr),
           csr_segment_sum_reference(msgs, row_ptr))


@pytest.mark.cuda
@pytest.mark.parametrize('N,E,F', [(2048, 4096, 64), (8192, 16384, 256),
                                   (64, 300, 37), (64, 200, 5)])
def test_fused_gather_segment_sum_kernel_matches_plain_version(cuda, N, E,
                                                               F):
    rng = np.random.RandomState(N + E + F)
    perm, row_ptr = edges_to_csr(rng.randint(0, N, E), N)
    h = torch.from_numpy(rng.rand(N, F).astype(np.float32)).to(cuda)
    src = torch.from_numpy(rng.randint(0, N, E).astype(np.int32)[perm])
    src, row_ptr = src.to(cuda), torch.from_numpy(row_ptr).to(cuda)
    before = fused_gather_segment_sum.launches
    out = fused_gather_segment_sum(h, src, row_ptr)
    torch.cuda.synchronize()
    assert fused_gather_segment_sum.launches == before + 1
    assert torch.equal(out, fused_gather_segment_sum(h, src, row_ptr))
    _close(out, csr_neighbor_sum_reference(h, src, row_ptr))


@pytest.mark.cuda
def test_softmax_backward_matches_plain_autograd(cuda):
    """The Function's gradient (kernel forward, P3 in the backward)
    against autograd through the plain version, on the card."""
    rng = np.random.RandomState(5)
    perm, row_ptr = edges_to_csr(rng.randint(0, 500, 6144), 512)
    logits = torch.from_numpy(rng.randn(6144, 1).astype(np.float32)[perm])
    w = torch.from_numpy(rng.randn(6144, 1).astype(np.float32)).to(cuda)
    row_ptr = torch.from_numpy(row_ptr).to(cuda)
    grads = []
    before = csr_segment_sum.launches
    for fn in (csr_segment_softmax, csr_segment_softmax_reference):
        x = logits.to(cuda).requires_grad_()
        (fn(x, row_ptr) * w).sum().backward()
        grads.append(x.grad)
    assert csr_segment_sum.launches == before + 1
    _close(*grads)


@pytest.mark.cuda
def test_training_step_gradients_match_the_cpu(cuda):
    """One step of a small dropout-free PAGTN on the card and on the CPU
    from the same seed: losses and every parameter's gradient agree."""
    X = PagtnMolGraphFeaturizer().featurize(
        ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1'])
    y = np.random.RandomState(0).randint(0, 2, (4, 3)).astype(np.float32)
    kw = dict(n_tasks=3, mode='classification', batch_size=4, num_layers=2,
              dropout=0.0, seed=1)
    models = [PagtnModel(device=d, **kw) for d in (cuda, 'cpu')]
    losses = [m.fit_on_batch(X, y, np.ones_like(y)) for m in models]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    cpu = dict(models[1].module.named_parameters())
    for name, p in models[0].module.named_parameters():
        # attn.bias: the softmax is shift invariant, its exact gradient is 0
        assert name.endswith('attn.bias') or p.grad.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   cpu[name].grad.numpy(), atol=1e-5,
                                   err_msg=name)


# P4, against the plain version in float32 from the same inputs: the
# forward within 1e-5 (float32) and 2e-2 (bfloat16: p and the output
# rounded), the gradients within 1e-4 and 5e-2, scaled by max(1, |ref|);
# the bfloat16 o and each bfloat16 gradient also within 7e-3 and 1e-2 of
# their own max |ref|, which sound kernels meet and a kernel with one fault
# does not (scripts/flash_controls.py)
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 5e-2)}
FLASH_FWD_RTOL = 7e-3
FLASH_GRAD_RTOL = 1e-2


def _flash_run(fn, q, k, v, w, cast):
    """Output and q, k, v gradients of ``fn`` under the loss sum(out * w)."""
    ts = [t.detach().clone().to(cast).requires_grad_() for t in (q, k, v)]
    out = fn(*ts, q.shape[-1] ** -0.5)
    (out.float() * w.float()).sum().backward()
    return [out.detach()] + [t.grad for t in ts]


# S 64 (under one 128-row block), 128, 200 and 1000 (ragged against 64
# and 128), 384 with D 32; B*H of 1.  The bf16 backward runs two consumer
# warpgroups (128 own rows) a block at every S: at S 64 the second owns no
# valid rows.
@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,H,S,D', [(2, 12, 128, 64), (1, 3, 200, 32),
                                     (1, 1, 64, 64), (2, 3, 200, 64),
                                     (1, 2, 1000, 64), (2, 2, 384, 32)])
def test_flash_attention_kernels_match_plain_version(cuda, dtype, B, H, S,
                                                     D):
    rng = np.random.RandomState(S + D)
    q, k, v, w = (torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32))
                  .to(cuda, dtype) for _ in range(4))
    counts = [fn.launches for fn in (flash_attention,
                                     flash_attention_bwd_dkv,
                                     flash_attention_bwd_dq)]
    outs = [_flash_run(flash_attention, q, k, v, w, dtype),
            _flash_run(flash_attention_reference, q, k, v, w, torch.float32)]
    torch.cuda.synchronize()
    assert [fn.launches for fn in (flash_attention, flash_attention_bwd_dkv,
                                   flash_attention_bwd_dq)] \
        == [c + 1 for c in counts]
    for i, (a, ref) in enumerate(zip(*outs)):
        tol = FLASH_TOL[dtype][i > 0] * max(1.0, ref.abs().max().item())
        assert a.dtype == dtype
        err = (a.float() - ref).abs().max().item()
        assert err <= tol, i
        if dtype == torch.bfloat16:
            rtol = FLASH_GRAD_RTOL if i > 0 else FLASH_FWD_RTOL
            assert err <= rtol * ref.abs().max().item(), i
    # no atomics: the output and every gradient repeat bit for bit
    again = _flash_run(flash_attention, q, k, v, w, dtype)
    for i, (a, b) in enumerate(zip(outs[0], again)):
        assert torch.equal(a, b), i


# m and l of the forward against the plain version's, per row
STAT_RTOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('D', [32, 64])
@pytest.mark.parametrize('S', [1, 63, 64, 65, 129, 200])
def test_flash_forward_kernel_matches_plain_version(cuda, dtype, D, S):
    """The forward alone at S under, on and past a 64-key tile and a
    128-query block: o within FLASH_TOL (and, in bfloat16, FLASH_FWD_RTOL
    of its own max |ref|), m and l within 1e-5 of max(1, |ref|) row by
    row, one launch, a bit-identical repeat."""
    rng = np.random.RandomState(7 * S + D)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, S, D).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    scale = D ** -0.5
    before = flash_attention.launches
    o, m, l = flash_attention_forward(q, k, v, scale)
    again = flash_attention_forward(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    # in float32 from the same inputs, as the other P4 checks
    ref_o, ref_m, ref_l = _forward_reference(q.float(), k.float(),
                                             v.float(), scale)
    tol = FLASH_TOL[dtype][0] * max(1.0, ref_o.abs().max().item())
    assert o.dtype == dtype
    err = (o.float() - ref_o).abs().max().item()
    assert err <= tol
    if dtype == torch.bfloat16:
        assert err <= FLASH_FWD_RTOL * ref_o.abs().max().item()
    for a, ref in ((m, ref_m), (l, ref_l)):
        assert bool(((a - ref).abs()
                     <= STAT_RTOL * ref.abs().clamp_min(1.0)).all())
    for a, b in zip((o, m, l), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('D', [32, 64])
@pytest.mark.parametrize('S', [65, 128, 200, 512])
def test_flash_f32_forward_on_the_tensor_cores_matches_plain_version(cuda, S,
                                                                     D):
    """The float32 forward, 3xTF32 on the tensor cores: o within
    FLASH_TOL's 1e-5 of max(1, |ref|) and m and l within STAT_RTOL of
    max(1, |ref|) row by row, against the plain version in float32 (no
    TF32: that keeps about 11 bits), bit-identical on a repeat."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.RandomState(3 * S + D)
    q, k, v = (torch.from_numpy(rng.randn(4, 3, S, D).astype(np.float32))
               .to(cuda) for _ in range(3))
    scale = D ** -0.5
    o, m, l = flash_attention_forward(q, k, v, scale)
    again = flash_attention_forward(q, k, v, scale)
    ref_o, ref_m, ref_l = _forward_reference(q, k, v, scale)
    torch.cuda.synchronize()
    assert o.dtype == m.dtype == l.dtype == torch.float32
    tol = FLASH_TOL[torch.float32][0] * max(1.0, ref_o.abs().max().item())
    assert (o - ref_o).abs().max().item() <= tol
    for a, ref in ((m, ref_m), (l, ref_l)):
        assert bool(((a - ref).abs()
                     <= STAT_RTOL * ref.abs().clamp_min(1.0)).all())
    for a, b in zip((o, m, l), again):
        assert torch.equal(a, b)


def _flash_bwd64(q, k, v, do, m, l, di, scale):
    """The backward kernels' formulas in float64 from the same inputs and
    statistics: ``(dq, dk, dv)``."""
    q, k, v, do, m, l, di = (t.double() for t in (q, k, v, do, m, l, di))
    p = torch.exp(q @ k.transpose(-1, -2) * scale - m[..., None]) \
        / l[..., None]
    ds = (do @ v.transpose(-1, -2) - di[..., None]) * p * scale
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


# S under, on and past a 64-row tile and 128 rows, and several tiles
@pytest.mark.cuda
@pytest.mark.parametrize('D', [32, 64])
@pytest.mark.parametrize('S', [1, 63, 64, 65, 129, 200, 512])
def test_flash_f32_backward_on_the_tensor_cores_matches_plain_version(
        cuda, S, D):
    """The float32 dK/dV and dQ kernels, 3xTF32 on the tensor cores, from
    the forward kernel's m and l: each gradient within FLASH_TOL's 1e-4 of
    max(1, |ref|) of the plain version in float32 and within 1e-5 of
    max(1, |g|) of the same formulas in float64, one launch each, and
    bit-identical on a repeat."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.RandomState(5 * S + D)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 3, S, D).astype(np.float32))
                   .to(cuda) for _ in range(4))
    scale = D ** -0.5
    o, m, l = flash_attention_forward(q, k, v, scale)
    di = (o * do).sum(-1)
    args = (q, k, v, do, m, l, di, scale)
    before = [fn.launches for fn in (flash_attention_bwd_dkv,
                                     flash_attention_bwd_dq)]
    dk, dv = flash_attention_bwd_dkv(*args)
    dq = flash_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (flash_attention_bwd_dkv,
                                   flash_attention_bwd_dq)] \
        == [c + 1 for c in before]
    ref_dk, ref_dv = flash_attention_bwd_dkv_reference(*args)
    ref_dq = flash_attention_bwd_dq_reference(*args)
    exact = _flash_bwd64(*args)
    for name, a, ref, ref64 in (('dq', dq, ref_dq, exact[0]),
                                ('dk', dk, ref_dk, exact[1]),
                                ('dv', dv, ref_dv, exact[2])):
        assert a.dtype == torch.float32
        tol = FLASH_TOL[torch.float32][1] * max(1.0, ref.abs().max().item())
        assert (a - ref).abs().max().item() <= tol, name
        tol64 = 1e-5 * max(1.0, ref64.abs().max().item())
        assert (a.double() - ref64).abs().max().item() <= tol64, name
    again = flash_attention_bwd_dkv(*args) + (flash_attention_bwd_dq(*args),)
    for a, b in zip((dk, dv, dq), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(TypeError):
        flash_attention(q, q, q.bfloat16(), 0.125)
    with pytest.raises(ValueError):
        flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                        q[..., :48].contiguous(), 0.125)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q,
                        0.125)
    with pytest.raises(ValueError):
        flash_attention(q, q, q.cpu(), 0.125)


@pytest.mark.cuda
def test_encoder_logits_match_the_cpu(cuda):
    """A small float32 encoder from one seed on the card and on the CPU,
    with a padding mask: logits within 1e-4 (sums in another order)."""
    kw = dict(vocab_size=40, hidden=64, layers=2, heads=2, intermediate=128,
              max_positions=34, seed=3)
    ids = torch.from_numpy(np.random.RandomState(0).randint(4, 40, (4, 32)))
    mask = torch.ones(4, 32)
    mask[1, 20:] = 0
    out = []
    for device in (cuda, 'cpu'):
        model = BertEncoderMLM(device=device, **kw).eval()
        with torch.no_grad():
            out.append(model(ids.to(device), mask.to(device)).cpu())
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), atol=1e-4)
