"""Data pipeline: memory-mapped token datasets, packing, blending, samplers
(the counterpart of ``megatron_llm_tpu/data/``; every module is a copy of
its JAX counterpart with its imports changed).

Reference: ``megatron/data/`` — ``indexed_dataset.py`` (mmap bin/idx),
``gpt_dataset.py`` (packed GPT samples with cached index triples),
``instruction_dataset.py``, ``blendable_dataset.py``, ``data_samplers.py``,
and the C++ index builders in ``helpers.cpp``, built with ``g++`` at first
use and bound through ctypes (``helpers.py``).  The ``.bin``/``.idx`` files
and the cached index ``.npy`` files are the JAX package's, byte for byte,
so a corpus written by ``tools/preprocess_data.py`` reads in both
packages.  ``dataset_utils.py`` and the BERT/T5/ICT/REALM datasets wait
for the BERT/T5 slice.
"""

from megatron_llm_torch.data.indexed_dataset import (  # noqa: F401
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
    best_fitting_dtype,
    make_builder,
    make_dataset,
)
from megatron_llm_torch.data.gpt_dataset import (  # noqa: F401
    GPTDataset,
    build_train_valid_test_datasets,
)
from megatron_llm_torch.data.blendable_dataset import (  # noqa: F401
    BlendableDataset,
)
from megatron_llm_torch.data.data_samplers import (  # noqa: F401
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
    build_pretraining_data_loader,
)
