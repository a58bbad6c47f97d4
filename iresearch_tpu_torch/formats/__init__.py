"""The port's segment formats: copies of ``iresearch_tpu/formats`` plus the
torch unpack."""

from iresearch_tpu_torch.formats.bitpack import BITS
from iresearch_tpu_torch.formats.spec import (
    BLOCK,
    NUM_CLASSES,
    TermCols,
    IndexFeatures,
)
from iresearch_tpu_torch.formats.postings import FieldPostings, encode_field_postings

__all__ = [
    "BLOCK",
    "BITS",
    "NUM_CLASSES",
    "TermCols",
    "IndexFeatures",
    "FieldPostings",
    "encode_field_postings",
]
