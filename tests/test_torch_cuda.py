"""Tests of the port that need a CUDA device: each CUDA kernel against its
plain PyTorch version on the card.  They skip where there is no GPU.  This
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from deepchem_tpu_torch.ops.csr_segment import (
    csr_segment_softmax, csr_segment_softmax_reference, edges_to_csr)

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
