"""deepchem_tpu_torch: the PyTorch and CUDA port of ``deepchem_tpu``.

Plain tensor code is PyTorch; the JAX package's Pallas kernels are CUDA
kernels written for Hopper (``csrc/``), built at first use
(``kernels/build.py``).  Entry points run on the current CUDA device unless
the caller passes ``device='cpu'``.
"""

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.feat import (ConvMolFeaturizer,
                                     PagtnMolGraphFeaturizer, SmilesTokenizer)
from deepchem_tpu_torch.metrics import Metric, roc_auc_score
from deepchem_tpu_torch.models import (BertEncoderMLM, GraphConvModel,
                                       PagtnModel)

__all__ = ['BertEncoderMLM', 'ConvMolFeaturizer', 'GraphConvModel', 'Metric',
           'NumpyDataset', 'PagtnMolGraphFeaturizer', 'PagtnModel',
           'SmilesTokenizer', 'roc_auc_score']
