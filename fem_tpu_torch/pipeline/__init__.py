"""The batched mapping engine on one CUDA device."""
