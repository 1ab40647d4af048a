from fem_tpu_torch.native.emitter import NativeEmitter
from fem_tpu_torch.native.mapper import NativeCpuMapper

__all__ = ["NativeCpuMapper", "NativeEmitter"]
