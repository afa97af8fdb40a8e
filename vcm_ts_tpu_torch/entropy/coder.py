"""Host-side entropy-coding orchestration.

Equivalent of the reference EntropyCoder shim
(DCVC_HEM/src/entropy_models/entropy_models.py:9-51): one buffered encoder
shared by all planes of a frame (z-mv, mv-y steps, z, y steps interleave into
a single stream), and a sequential decoder.
"""

from __future__ import annotations

import numpy as np

from .rans import BufferedRansEncoder, RansDecoder
from .tables import CdfTable


class EntropyCoder:
    def __init__(self):
        self.encoder = BufferedRansEncoder()
        self.decoder = RansDecoder()

    # encode --------------------------------------------------------------
    def reset_encoder(self):
        self.encoder.reset()

    def encode_with_indexes(self, symbols, indexes, table: CdfTable):
        self.encoder.encode_with_indexes(
            np.asarray(symbols).reshape(-1).astype(np.int32),
            np.asarray(indexes).reshape(-1).astype(np.int32),
            table.cdf, table.sizes, table.offsets)

    def flush_encoder(self) -> bytes:
        return self.encoder.flush()

    # decode --------------------------------------------------------------
    def set_stream(self, stream: bytes):
        self.decoder.set_stream(stream)

    def decode_stream(self, indexes, table: CdfTable) -> np.ndarray:
        """Returns int32 symbols shaped like `indexes`."""
        indexes = np.asarray(indexes)
        out = self.decoder.decode_stream(
            indexes.reshape(-1).astype(np.int32),
            table.cdf, table.sizes, table.offsets)
        return out.reshape(indexes.shape)
