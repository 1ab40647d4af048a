from fem_tpu_torch.golden.model import GoldenMapper, MappingStats

__all__ = ["GoldenMapper", "MappingStats"]
