"""Weights in and out of the port: HuggingFace and Meta checkpoints to the
port's checkpoint and back, and Megatron-LM ``mp_rank`` checkpoints both
ways (the twins of the repo's ``weights_conversion/``)."""
