"""GIM container codec.

Copy of ``pointcloudhookup_tpu/io/gim.py`` (``GimFile``, ``extract_gim``,
``write_gim``).  A ``.gim`` file is a 776-byte binary header followed by a
7z archive of the model tree (the reference's ui/compress.py:50-70 for
extract, :84-109 for repack; ui/save_cbm.py:109-170 for the save path,
including zero-padding short headers and a zero default header).
"""

from __future__ import annotations

import os
from typing import Optional

from pointcloudhookup_tpu_torch.io.sevenzip import Entry, pack_directory, read_7z, safe_join

HEADER_SIZE = 776


class GimFile:
    """Parsed GIM container: header bytes + archive entries."""

    def __init__(self, header: bytes, entries: list[Entry]):
        self.header = header
        self.entries = entries

    @staticmethod
    def read(path: str) -> "GimFile":
        if not str(path).endswith(".gim"):
            raise ValueError(f"not a .gim path: {path!r}")
        with open(path, "rb") as f:
            header = f.read(HEADER_SIZE)
            payload = f.read()
        if len(header) < HEADER_SIZE:
            raise ValueError(f"GIM header truncated ({len(header)} < {HEADER_SIZE})")
        return GimFile(header, read_7z(payload))


def extract_gim(gim_path: str, output_folder: str = "output") -> tuple[str, bytes]:
    """Unpack <name>.gim into output_folder/<name>/ (mirrors
    GIMExtractor.extract_embedded_7z); returns (folder, header)."""
    gim = GimFile.read(gim_path)
    name = os.path.basename(gim_path)[:-4]
    target = os.path.join(output_folder, name)
    os.makedirs(target, exist_ok=True)
    for e in gim.entries:
        p = safe_join(target, e.name)
        if e.is_dir:
            os.makedirs(p, exist_ok=True)
            continue
        os.makedirs(os.path.dirname(p) or target, exist_ok=True)
        with open(p, "wb") as f:
            f.write(e.data or b"")
    return target, gim.header


def write_gim(
    folder: str,
    output_path: str,
    header: Optional[bytes] = None,
    level: int = 9,
    store: bool = False,
) -> None:
    """Re-pack a model tree into a .gim (header + 7z).

    header semantics follow the reference's ui/save_cbm.py:141-150: a
    short header is zero-padded to 776 bytes; None means all zeros.
    level=9 + an encoded header match the reference's save-path
    `7z a -mx=9` output shape (the reference's ui/save_cbm.py:72-89).
    """
    if header is None:
        header = b"\x00" * HEADER_SIZE
    if len(header) < HEADER_SIZE:
        header = header + b"\x00" * (HEADER_SIZE - len(header))
    header = header[:HEADER_SIZE]
    payload = pack_directory(folder, level=level, store=store, encode_header=not store)
    out_dir = os.path.dirname(output_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(output_path, "wb") as f:
        f.write(header)
        f.write(payload)
