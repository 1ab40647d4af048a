from fem_tpu_torch.core.encoding import (
    BASE_A,
    BASE_AMBIG,
    CHAR_TO_CODE,
    CODE_TO_CHAR,
    decode,
    encode,
    reverse_complement_codes,
)

__all__ = [
    "BASE_A",
    "BASE_AMBIG",
    "CHAR_TO_CODE",
    "CODE_TO_CHAR",
    "decode",
    "encode",
    "reverse_complement_codes",
]
