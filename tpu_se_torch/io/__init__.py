"""File codecs the port needs, byte-compatible with ``tpu_se.io``.

A numpy copy of ``tpu_se/io`` (one module per namesake there), so the port
reads and writes the reference's files without importing the JAX package:

- ``wav``:   RIFF/WAVE PCM16 and NIST SPHERE in, mono PCM16 out; headerless
  int16 (``read_raw``/``write_raw``) and the HTK-container waveform.
- ``htk``:   big-endian HTK feature files (the ``.lps`` files).
- ``pfile``: the QuickNet pfile, the streaming ``PfileWriter`` and
  ``concat_pfiles``.
- ``norm``:  ``.norm`` text files and the statistics behind them.
- ``wts``:   the reference ``.wts`` weight files.
- ``atomic``, ``readahead``: atomic writes, ordered parallel reads.
"""

from tpu_se_torch.io.atomic import atomic_write
from tpu_se_torch.io.htk import HTKHeader, frames_in_htk_file, read_htk, write_htk
from tpu_se_torch.io.norm import (
    compute_norm, compute_norm_pfile, read_norm, write_norm,
)
from tpu_se_torch.io.pfile import (
    PFILE_HEADER_SIZE, PFile, PfileWriter, concat_pfiles, read_pfile,
    read_pfile_header, read_pfile_meta, read_pfile_rows, write_pfile,
)
from tpu_se_torch.io.readahead import ordered_readahead
from tpu_se_torch.io.wav import (
    read_htk_waveform, read_raw, read_wav, write_raw, write_wav,
)
from tpu_se_torch.io.wts import read_wts, write_wts

__all__ = [
    "atomic_write",
    "read_wav", "write_wav", "read_raw", "write_raw", "read_htk_waveform",
    "read_htk", "write_htk", "HTKHeader", "frames_in_htk_file",
    "PFILE_HEADER_SIZE", "PFile", "PfileWriter", "concat_pfiles",
    "read_pfile", "write_pfile", "read_pfile_header", "read_pfile_meta",
    "read_pfile_rows",
    "read_norm", "write_norm", "compute_norm", "compute_norm_pfile",
    "read_wts", "write_wts",
    "ordered_readahead",
]
