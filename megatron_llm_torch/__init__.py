"""PyTorch port of megatron_llm_tpu for one NVIDIA H100.

Slice 1 ports the paged-KV serving engine for Llama-family models: the
model's inference path (``models/``), the ragged paged-attention and
RMSNorm kernels written in CUDA for ``sm_90a`` (``csrc/``, wrapped in
``ops/kernels/``), the engine (``serving/``) and its HTTP server
(``text_generation_server.py``, ``run_text_generation_server.py``).
Slice 2 ports the single-device training step: the model's training
path with the per-token loss (``ops/cross_entropy.py``), flash attention
forward and backward and the RMSNorm backward as CUDA kernels, the
optimizer stack (``optimizer/``), the train step and loop
(``training.py``) and the ``finetune.py`` entry point with its flags
(``arguments.py``).
Slice 5 ports real weights, text and data: checkpoints in the JAX
package's layout (``checkpointing.py``), the tokenizers (``tokenizer/``)
and the mmap data loaders with their native index helpers (``data/``).
Module names follow the JAX package so each counterpart is easy to find.
The package imports neither ``jax`` nor ``megatron_llm_tpu``.
"""
