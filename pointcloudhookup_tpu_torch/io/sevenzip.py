"""Minimal 7z archive codec (pure Python, stdlib lzma + zlib).

Copy of ``pointcloudhookup_tpu/io/sevenzip.py``, whole, so that the PyTorch
port imports nothing of the JAX package.

The reference handles GIM payloads with py7zr / the 7z CLI (its
ui/compress.py:64-107 and ui/save_cbm.py:68-107);
neither is a dependency, so this module implements the subset of the
7z container format the GIM workflow needs:

  read:  archives whose folders are linear coder chains of
         Copy / LZMA1 / LZMA2 / Delta / BCJ-x86 (covers 7z CLI defaults
         and py7zr's LZMA2 + COPY modes), plus BCJ2 folders (the
         4-stream x86 branch converter, via the general coder-graph
         resolver); plain or encoded headers.
  write: single-folder archives, LZMA2-compressed (or Copy/store),
         with names, sizes, CRCs, and directory/empty-file entries.

Format reference: the public 7zFormat.txt structure description.  This is
an independent implementation, not a translation of py7zr.
"""

from __future__ import annotations

import dataclasses
import io
import lzma
import os
import re
import struct
import zlib
from typing import BinaryIO, Iterable, Optional

MAGIC = b"7z\xbc\xaf\x27\x1c"

# property ids
K_END = 0x00
K_HEADER = 0x01
K_MAIN_STREAMS = 0x04
K_FILES_INFO = 0x05
K_PACK_INFO = 0x06
K_UNPACK_INFO = 0x07
K_SUBSTREAMS_INFO = 0x08
K_SIZE = 0x09
K_CRC = 0x0A
K_FOLDER = 0x0B
K_CODERS_UNPACK_SIZE = 0x0C
K_NUM_UNPACK_STREAM = 0x0D
K_EMPTY_STREAM = 0x0E
K_EMPTY_FILE = 0x0F
K_NAMES = 0x11
K_MTIME = 0x14
K_ATTRIBUTES = 0x15
K_ENCODED_HEADER = 0x17
K_START_POS = 0x18
K_DUMMY = 0x19

CODEC_COPY = b"\x00"
CODEC_DELTA = b"\x03"
CODEC_LZMA2 = b"\x21"
CODEC_LZMA1 = b"\x03\x01\x01"
CODEC_BCJ_X86 = b"\x03\x03\x01\x03"
CODEC_BCJ_X86_NEW = b"\x04"
CODEC_BCJ2 = b"\x03\x03\x01\x1b"

FILE_ATTRIBUTE_DIRECTORY = 0x10
FILE_ATTRIBUTE_ARCHIVE = 0x20


class SevenZipError(ValueError):
    pass


# ---------------------------------------------------------------- numbers
def _read_byte(f: BinaryIO) -> int:
    b = f.read(1)
    if not b:  # truncated header: surface as a clean format error
        raise SevenZipError("unexpected end of header data")
    return b[0]


def read_number(f: BinaryIO) -> int:
    first = _read_byte(f)
    mask = 0x80
    value = 0
    for i in range(8):
        if not (first & mask):
            value |= (first & (mask - 1)) << (8 * i)
            return value
        value |= _read_byte(f) << (8 * i)
        mask >>= 1
    return value


def write_number(value: int) -> bytes:
    """7z variable-length number: n leading 1-bits in the first byte =>
    n extra little-endian bytes; remaining (7-n) first-byte bits are the
    value's high bits."""
    if value < 0:
        raise SevenZipError("negative number")
    for n in range(9):
        if n == 8 or value < (1 << (7 + 7 * n)):
            break
    if n == 8:
        return b"\xff" + value.to_bytes(8, "little")
    low = value & ((1 << (8 * n)) - 1)
    high = value >> (8 * n)
    mask = (0xFF << (8 - n)) & 0xFF
    return bytes([mask | high]) + low.to_bytes(n, "little")


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise SevenZipError("unexpected end of header data")
    return b


def _read_bits(f: BinaryIO, count: int) -> list[bool]:
    bits = []
    b = 0
    avail = 0
    for _ in range(count):
        if not avail:
            b = _read_byte(f)
            avail = 8
        bits.append(bool(b & 0x80))
        b = (b << 1) & 0xFF
        avail -= 1
    return bits


def _write_bits(bits: Iterable[bool]) -> bytes:
    out = bytearray()
    acc = 0
    n = 0
    for bit in bits:
        acc = (acc << 1) | int(bool(bit))
        n += 1
        if n == 8:
            out.append(acc)
            acc, n = 0, 0
    if n:
        out.append(acc << (8 - n))
    return bytes(out)


def _read_all_or_bits(f: BinaryIO, count: int) -> list[bool]:
    all_defined = _read_byte(f)
    if all_defined:
        return [True] * count
    return _read_bits(f, count)


# ---------------------------------------------------------------- model
@dataclasses.dataclass
class Coder:
    codec_id: bytes
    num_in: int
    num_out: int
    props: bytes


@dataclasses.dataclass
class Folder:
    coders: list[Coder]
    bind_pairs: list[tuple[int, int]]  # (in_index, out_index)
    packed_indices: list[int]
    unpack_sizes: list[int] = dataclasses.field(default_factory=list)
    num_substreams: int = 1
    substream_sizes: list[int] = dataclasses.field(default_factory=list)
    crc_defined: bool = False  # folder-level CRC from UnpackInfo
    crc: Optional[int] = None
    substream_crcs: list[Optional[int]] = dataclasses.field(default_factory=list)

    def total_out(self) -> int:
        return sum(c.num_out for c in self.coders)

    def final_out_index(self) -> int:
        used = {o for _, o in self.bind_pairs}
        for i in range(self.total_out()):
            if i not in used:
                return i
        raise SevenZipError("no final output stream")

    def unpack_size(self) -> int:
        return self.unpack_sizes[self.final_out_index()]


@dataclasses.dataclass
class Entry:
    """One archived file/directory."""

    name: str
    data: Optional[bytes] = None  # None for directories
    is_dir: bool = False
    crc: Optional[int] = None

    @property
    def size(self) -> int:
        return len(self.data) if self.data else 0


# ---------------------------------------------------------------- codecs
def _lzma1_filter(props: bytes) -> dict:
    if len(props) < 5:
        raise SevenZipError("bad LZMA1 props")
    d = props[0]
    lc = d % 9
    d //= 9
    lp = d % 5
    pb = d // 5
    dict_size = struct.unpack("<I", props[1:5])[0]
    return dict(id=lzma.FILTER_LZMA1, lc=lc, lp=lp, pb=pb, dict_size=max(dict_size, 1 << 12))


def _lzma2_dict_size(prop: int) -> int:
    if prop > 40:
        raise SevenZipError("bad LZMA2 dict prop")
    if prop == 40:
        return 0xFFFFFFFF
    return (2 | (prop & 1)) << (prop // 2 + 11)


def _lzma2_prop_byte(dict_size: int) -> int:
    for code in range(41):
        if _lzma2_dict_size(code) >= dict_size:
            return code
    return 40


def _python_filter(coder: Coder) -> dict:
    cid = coder.codec_id
    if cid == CODEC_LZMA2:
        ds = _lzma2_dict_size(coder.props[0]) if coder.props else (1 << 24)
        return dict(id=lzma.FILTER_LZMA2, dict_size=min(ds, 1 << 26))
    if cid == CODEC_LZMA1:
        return _lzma1_filter(coder.props)
    if cid == CODEC_DELTA:
        dist = (coder.props[0] + 1) if coder.props else 1
        return dict(id=lzma.FILTER_DELTA, dist=dist)
    if cid in (CODEC_BCJ_X86, CODEC_BCJ_X86_NEW):
        return dict(id=lzma.FILTER_X86)
    raise SevenZipError(f"unsupported codec id {cid.hex()}")


def _bcj2_decode(main: bytes, call: bytes, jump: bytes, rc: bytes, out_size: int) -> bytes:
    """BCJ2 (4-stream x86 branch converter) decoder, from the published
    7-Zip method spec (coder id 0303011B).

    Output bytes copy from `main`; after an 0xE8/0xE9/0F 8x opcode a
    range-decoded bit (LZMA-style binary coder, 11-bit model, context =
    previous byte for E8, 256 for E9, 257 for Jcc) says whether the next
    four output bytes are a big-endian ABSOLUTE address stored in `call`
    or `jump`, converted back to the little-endian relative displacement
    x86 actually encodes."""
    probs = [1024] * (2 + 256)
    if len(rc) < 5:
        raise SevenZipError("BCJ2 control stream truncated")
    rng = 0xFFFFFFFF
    code = int.from_bytes(rc[1:5], "big")
    rcp = 5

    def decode_bit(i: int) -> int:
        nonlocal rng, code, rcp
        bound = (rng >> 11) * probs[i]
        if code < bound:
            rng = bound
            probs[i] += (2048 - probs[i]) >> 5
            bit = 0
        else:
            rng -= bound
            code -= bound
            probs[i] -= probs[i] >> 5
            bit = 1
        if rng < (1 << 24):
            rng = (rng << 8) & 0xFFFFFFFF
            nxt = rc[rcp] if rcp < len(rc) else 0
            code = ((code << 8) | nxt) & 0xFFFFFFFF
            rcp += 1
        return bit

    out = bytearray()
    mp = cp = jp = 0
    prev = 0
    while len(out) < out_size:
        if mp >= len(main):
            raise SevenZipError("BCJ2 main stream truncated")
        b = main[mp]
        mp += 1
        out.append(b)
        is_branch = (b & 0xFE) == 0xE8 or (prev == 0x0F and (b & 0xF0) == 0x80)
        if is_branch:
            # a prob bit is coded for EVERY branch byte (the encoder
            # emits bit=0 for branches it did not convert), so the bit
            # must be decoded unconditionally to stay in sync
            idx = prev if b == 0xE8 else (256 if b == 0xE9 else 257)
            if decode_bit(idx):
                if b == 0xE8:
                    src, sp = call, cp
                    cp += 4
                else:
                    src, sp = jump, jp
                    jp += 4
                if sp + 4 > len(src):
                    raise SevenZipError("BCJ2 address stream truncated")
                if len(out) + 4 > out_size:
                    raise SevenZipError("BCJ2 address crosses output end")
                absolute = int.from_bytes(src[sp : sp + 4], "big")
                rel = (absolute - (len(out) + 4)) & 0xFFFFFFFF
                out += rel.to_bytes(4, "little")
                prev = (rel >> 24) & 0xFF
                continue
        prev = b
    return bytes(out)


def _decode_one_coder(coder: Coder, inputs: list[bytes], out_size: int) -> bytes:
    """Decode a SINGLE coder given its already-decoded input streams
    (used by the general multi-stream folder path)."""
    cid = coder.codec_id
    if cid == CODEC_COPY:
        return inputs[0][:out_size]
    if cid == CODEC_BCJ2:
        if len(inputs) != 4:
            raise SevenZipError("BCJ2 requires 4 input streams")
        return _bcj2_decode(*inputs, out_size)
    if cid == CODEC_DELTA:
        dist = (coder.props[0] + 1) if coder.props else 1
        data = bytearray(inputs[0][:out_size])
        for i in range(dist, len(data)):
            data[i] = (data[i] + data[i - dist]) & 0xFF
        return bytes(data)
    if cid in (CODEC_LZMA1, CODEC_LZMA2):
        dec = lzma.LZMADecompressor(
            format=lzma.FORMAT_RAW, filters=[_python_filter(coder)]
        )
        try:
            out = dec.decompress(inputs[0], max_length=out_size)
            while len(out) < out_size and not dec.eof:
                chunk = dec.decompress(b"", max_length=out_size - len(out))
                if not chunk:
                    break
                out += chunk
        except lzma.LZMAError as exc:
            raise SevenZipError(f"coder decode failed: {exc}") from exc
        if len(out) < out_size:
            raise SevenZipError(f"coder produced {len(out)} of {out_size} bytes")
        return out[:out_size]
    raise SevenZipError(
        f"codec id {cid.hex()} not supported in multi-stream folders"
    )


def _decode_folder_general(folder: Folder, packed: list[bytes]) -> bytes:
    """Decode a folder whose coder graph is NOT a linear 1-in-1-out
    chain (BCJ2's 4-input converter being the real-world case,
    7z CLI x86 default: main/call/jump LZMA legs + a raw control leg).
    Streams are resolved recursively from the final output."""
    in_base, out_base = [], []
    ti = to = 0
    for c in folder.coders:
        in_base.append(ti)
        out_base.append(to)
        ti += c.num_in
        to += c.num_out
    bound = dict(folder.bind_pairs)  # in_index -> out_index
    packed_of_in = {gi: k for k, gi in enumerate(folder.packed_indices)}
    if len(packed) != len(folder.packed_indices):
        raise SevenZipError("pack stream count mismatch")
    memo: dict[int, bytes] = {}
    busy: set[int] = set()

    def out_stream(oi: int) -> bytes:
        if oi in memo:
            return memo[oi]
        if oi in busy:
            raise SevenZipError("cyclic coder binding")
        busy.add(oi)
        ci = 0
        for i, ob in enumerate(out_base):
            if ob <= oi:
                ci = i
        c = folder.coders[ci]
        ins = []
        for k in range(c.num_in):
            gi = in_base[ci] + k
            if gi in bound:
                ins.append(out_stream(bound[gi]))
            elif gi in packed_of_in:
                ins.append(packed[packed_of_in[gi]])
            else:
                raise SevenZipError(f"input stream {gi} is unbound")
        out = _decode_one_coder(c, ins, folder.unpack_sizes[oi])
        memo[oi] = out
        busy.discard(oi)
        return out

    return out_stream(folder.final_out_index())


def _decode_folder(folder: Folder, packed: list[bytes]) -> bytes:
    """Decode a linear coder chain folder."""
    for c in folder.coders:
        if c.num_in != 1 or c.num_out != 1:
            return _decode_folder_general(folder, packed)
    if len(folder.packed_indices) != 1 or len(packed) != 1:
        raise SevenZipError("multi-packed-stream folders not supported")
    # chain order: coder consuming the packed stream -> ... -> final out
    consumed_by = {in_i: out_i for in_i, out_i in folder.bind_pairs}
    chain = []
    in_idx = folder.packed_indices[0]
    while True:
        coder = folder.coders[in_idx]  # 1-in-1-out: stream index == coder index
        chain.append((in_idx, coder))
        out_idx = in_idx  # out stream index of this coder
        # find the coder whose input binds to this output
        nxt = None
        for bin_i, bout_i in folder.bind_pairs:
            if bout_i == out_idx:
                nxt = bin_i
                break
        if nxt is None:
            break
        in_idx = nxt

    data = packed[0]
    # single Copy coder
    if len(chain) == 1 and chain[0][1].codec_id == CODEC_COPY:
        return data[: folder.unpack_size()]
    # pure-python Delta-only or chains: build a python lzma raw filter list.
    # python applies filters in compression order (bcj/delta first, lzma
    # last); our chain is in DECODE order (lzma first), so reverse it.
    filters = []
    for _, coder in reversed(chain):
        if coder.codec_id == CODEC_COPY:
            continue
        filters.append(_python_filter(coder))
    if not filters:
        return data[: folder.unpack_size()]
    dec = lzma.LZMADecompressor(format=lzma.FORMAT_RAW, filters=filters)
    try:
        out = dec.decompress(data, max_length=folder.unpack_size())
        while len(out) < folder.unpack_size() and not dec.eof:
            chunk = dec.decompress(b"", max_length=folder.unpack_size() - len(out))
            if not chunk:
                break
            out += chunk
    except lzma.LZMAError as exc:  # corrupted packed stream
        raise SevenZipError(f"folder decode failed: {exc}") from exc
    if len(out) < folder.unpack_size():
        raise SevenZipError(
            f"folder decode produced {len(out)} of {folder.unpack_size()} bytes"
        )
    return out[: folder.unpack_size()]


# ---------------------------------------------------------------- reader
class _HeaderParser:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.pack_pos = 0
        self.pack_sizes: list[int] = []
        self.folders: list[Folder] = []

    def parse_streams_info(self):
        f = self.f
        while True:
            pid = read_number(f)
            if pid == K_END:
                return
            if pid == K_PACK_INFO:
                self._parse_pack_info()
            elif pid == K_UNPACK_INFO:
                self._parse_unpack_info()
            elif pid == K_SUBSTREAMS_INFO:
                self._parse_substreams_info()
            else:
                raise SevenZipError(f"unexpected id {pid:#x} in StreamsInfo")

    def _parse_pack_info(self):
        f = self.f
        self.pack_pos = read_number(f)
        num = read_number(f)
        while True:
            pid = read_number(f)
            if pid == K_END:
                return
            if pid == K_SIZE:
                self.pack_sizes = [read_number(f) for _ in range(num)]
            elif pid == K_CRC:
                defined = _read_all_or_bits(f, num)
                for d in defined:
                    if d:
                        _read_exact(f, 4)
            else:
                raise SevenZipError(f"unexpected id {pid:#x} in PackInfo")

    def _parse_folder(self) -> Folder:
        f = self.f
        num_coders = read_number(f)
        coders = []
        total_in = total_out = 0
        for _ in range(num_coders):
            flags = _read_byte(f)
            id_size = flags & 0x0F
            codec_id = f.read(id_size)
            num_in = num_out = 1
            if flags & 0x10:  # complex
                num_in = read_number(f)
                num_out = read_number(f)
            props = b""
            if flags & 0x20:
                props = f.read(read_number(f))
            if flags & 0x80:
                raise SevenZipError("alternative methods not supported")
            coders.append(Coder(codec_id, num_in, num_out, props))
            total_in += num_in
            total_out += num_out
        bind_pairs = []
        for _ in range(total_out - 1):
            bind_pairs.append((read_number(f), read_number(f)))
        num_packed = total_in - len(bind_pairs)
        if num_packed == 1:
            bound_ins = {i for i, _ in bind_pairs}
            packed = [i for i in range(total_in) if i not in bound_ins]
        else:
            packed = [read_number(f) for _ in range(num_packed)]
        return Folder(coders, bind_pairs, packed)

    def _parse_unpack_info(self):
        f = self.f
        pid = read_number(f)
        if pid != K_FOLDER:
            raise SevenZipError("expected kFolder")
        num_folders = read_number(f)
        external = _read_byte(f)
        if external:
            raise SevenZipError("external folders not supported")
        self.folders = [self._parse_folder() for _ in range(num_folders)]
        pid = read_number(f)
        if pid != K_CODERS_UNPACK_SIZE:
            raise SevenZipError("expected kCodersUnpackSize")
        for folder in self.folders:
            folder.unpack_sizes = [read_number(f) for _ in range(folder.total_out())]
        while True:
            pid = read_number(f)
            if pid == K_END:
                return
            if pid == K_CRC:
                defined = _read_all_or_bits(f, num_folders)
                for folder, d in zip(self.folders, defined):
                    folder.crc_defined = d
                    if d:
                        folder.crc = struct.unpack("<I", _read_exact(f, 4))[0]
            else:
                raise SevenZipError(f"unexpected id {pid:#x} in UnpackInfo")

    def _parse_substreams_info(self):
        f = self.f
        nums = [1] * len(self.folders)
        pid = read_number(f)
        if pid == K_NUM_UNPACK_STREAM:
            nums = [read_number(f) for _ in self.folders]
            pid = read_number(f)
        for folder, n in zip(self.folders, nums):
            folder.num_substreams = n
        if pid == K_SIZE:
            for folder in self.folders:
                sizes = []
                if folder.num_substreams:
                    for _ in range(folder.num_substreams - 1):
                        sizes.append(read_number(f))
                    sizes.append(folder.unpack_size() - sum(sizes))
                folder.substream_sizes = sizes
            pid = read_number(f)
        else:
            for folder in self.folders:
                folder.substream_sizes = (
                    [folder.unpack_size()] if folder.num_substreams == 1 else []
                )
        while pid != K_END:
            if pid == K_CRC:
                # digests are stored ONLY for substreams whose CRC is not
                # already known from UnpackInfo: a single-substream folder
                # with a defined folder CRC contributes no digest here.
                # Getting this count wrong misaligns every following byte
                # (real `7z a` archives mix defined/undefined folder CRCs).
                for folder in self.folders:
                    folder.substream_crcs = [None] * folder.num_substreams
                    if folder.num_substreams == 1 and folder.crc_defined:
                        folder.substream_crcs[0] = folder.crc
                unknown = [
                    (folder, s)
                    for folder in self.folders
                    for s in range(folder.num_substreams)
                    if not (folder.num_substreams == 1 and folder.crc_defined)
                ]
                defined = _read_all_or_bits(f, len(unknown))
                for (folder, s), d in zip(unknown, defined):
                    if d:
                        folder.substream_crcs[s] = struct.unpack("<I", _read_exact(f, 4))[0]
            else:
                raise SevenZipError(f"unexpected id {pid:#x} in SubStreamsInfo")
            pid = read_number(f)


def _parse_files_info(f: BinaryIO, entries_out: list[dict]):
    num_files = read_number(f)
    files = [dict(name="", empty_stream=False, empty_file=False, attrib=0) for _ in range(num_files)]
    num_empty = 0
    while True:
        prop = read_number(f)
        if prop == K_END:
            break
        size = read_number(f)
        end = f.tell() + size
        if prop == K_EMPTY_STREAM:
            bits = _read_bits(f, num_files)
            for fi, b in zip(files, bits):
                fi["empty_stream"] = b
            num_empty = sum(bits)
        elif prop == K_EMPTY_FILE:
            bits = _read_bits(f, num_empty)
            it = iter(bits)
            for fi in files:
                if fi["empty_stream"]:
                    fi["empty_file"] = next(it)
        elif prop == K_NAMES:
            external = _read_byte(f)
            if external:
                raise SevenZipError("external names not supported")
            blob = f.read(size - 1)
            names = blob.decode("utf-16-le").split("\x00")
            for fi, name in zip(files, names):
                fi["name"] = name
        elif prop == K_ATTRIBUTES:
            defined = _read_all_or_bits(f, num_files)
            external = _read_byte(f)
            for fi, d in zip(files, defined):
                if d:
                    fi["attrib"] = struct.unpack("<I", _read_exact(f, 4))[0]
        f.seek(end)
    entries_out.extend(files)


def read_7z(data: bytes) -> list[Entry]:
    """Parse a .7z archive from bytes; returns the entry list with data."""
    if data[:6] != MAGIC:
        raise SevenZipError("bad 7z signature")
    if len(data) < 32:
        raise SevenZipError("truncated 7z start header")
    nh_offset, nh_size = struct.unpack_from("<QQ", data, 12)
    header_blob = data[32 + nh_offset : 32 + nh_offset + nh_size]
    if not header_blob:
        return []
    f = io.BytesIO(header_blob)
    pid = read_number(f)
    if pid == K_ENCODED_HEADER:
        hp = _HeaderParser(f)
        hp.parse_streams_info()
        packed_base = 32 + hp.pack_pos
        offs = packed_base
        packs = []
        for sz in hp.pack_sizes:
            packs.append(data[offs : offs + sz])
            offs += sz
        if len(hp.folders) != 1:
            raise SevenZipError("encoded header with multiple folders")
        decoded = _decode_folder(hp.folders[0], packs)
        if hp.folders[0].crc_defined and (
            zlib.crc32(decoded) & 0xFFFFFFFF
        ) != hp.folders[0].crc:
            raise SevenZipError("encoded header CRC mismatch")
        f = io.BytesIO(decoded)
        pid = read_number(f)
    if pid != K_HEADER:
        raise SevenZipError(f"expected kHeader, got {pid:#x}")

    parser = None
    file_props: list[dict] = []
    while True:
        pid = read_number(f)
        if pid == K_END:
            break
        if pid == K_MAIN_STREAMS:
            parser = _HeaderParser(f)
            parser.parse_streams_info()
        elif pid == K_FILES_INFO:
            _parse_files_info(f, file_props)
        else:
            raise SevenZipError(f"unexpected id {pid:#x} in Header")

    # decode all folders, verify CRCs, and split substreams
    substream_data: list[bytes] = []
    substream_crcs: list[Optional[int]] = []
    if parser is not None:
        offs = 32 + parser.pack_pos
        pack_blobs = []
        for sz in parser.pack_sizes:
            pack_blobs.append(data[offs : offs + sz])
            offs += sz
        pack_i = 0
        for folder in parser.folders:
            n_pack = len(folder.packed_indices)
            blob = _decode_folder(folder, pack_blobs[pack_i : pack_i + n_pack])
            pack_i += n_pack
            if folder.crc_defined and (zlib.crc32(blob) & 0xFFFFFFFF) != folder.crc:
                raise SevenZipError("folder CRC mismatch")
            pos = 0
            sizes = folder.substream_sizes or [folder.unpack_size()]
            crcs = folder.substream_crcs or [None] * len(sizes)
            for sz, crc in zip(sizes, crcs):
                piece = blob[pos : pos + sz]
                if crc is not None and (zlib.crc32(piece) & 0xFFFFFFFF) != crc:
                    raise SevenZipError("substream CRC mismatch")
                substream_data.append(piece)
                substream_crcs.append(crc)
                pos += sz

    entries = []
    it = iter(zip(substream_data, substream_crcs))
    for fp in file_props:
        is_dir = fp["empty_stream"] and not fp["empty_file"]
        crc = None
        if fp["empty_stream"]:
            payload = None if is_dir else b""
        else:
            payload, crc = next(it)
        entries.append(
            Entry(
                name=fp["name"].replace("\\", "/"),
                data=payload,
                is_dir=is_dir,
                crc=crc,
            )
        )
    return entries


# ---------------------------------------------------------------- writer
def write_7z(
    entries: list[Entry],
    level: int = 1,
    store: bool = False,
    encode_header: bool = False,
) -> bytes:
    """Serialize entries into a single-folder 7z archive.

    level: LZMA2 preset (the reference packs with -mx=1 for speed on
    extract/repack and -mx=9 on save; both are accepted here).
    store=True writes a Copy (uncompressed) folder like py7zr's
    FILTER_COPY fallback (ref: ui/compress.py:80).
    encode_header=True compresses the file header into a trailing packed
    stream referenced by a kEncodedHeader record — the layout the real
    7z CLI emits at its -mx defaults (ref: ui/save_cbm.py:72-89), so
    readers of our .gim output see the same shape the CLI would produce.
    """
    content_entries = [e for e in entries if not e.is_dir and e.data]
    empty_entries = [e for e in entries if e.is_dir or not e.data]
    ordered = content_entries + empty_entries  # substream order must match

    payload = b"".join(e.data for e in content_entries)
    if store:
        packed = payload
        coder = Coder(CODEC_COPY, 1, 1, b"")
    else:
        dict_size = 1 << 24
        comp = lzma.LZMACompressor(
            format=lzma.FORMAT_RAW,
            filters=[dict(id=lzma.FILTER_LZMA2, preset=level, dict_size=dict_size)],
        )
        packed = comp.compress(payload) + comp.flush()
        coder = Coder(CODEC_LZMA2, 1, 1, bytes([_lzma2_prop_byte(dict_size)]))

    out = io.BytesIO()

    def w(b: bytes):
        out.write(b)

    have_stream = bool(content_entries)
    # ---- header
    hdr = io.BytesIO()
    hdr.write(write_number(K_HEADER))
    if have_stream:
        hdr.write(write_number(K_MAIN_STREAMS))
        # PackInfo
        hdr.write(write_number(K_PACK_INFO))
        hdr.write(write_number(0))  # pack pos
        hdr.write(write_number(1))  # num pack streams
        hdr.write(write_number(K_SIZE))
        hdr.write(write_number(len(packed)))
        hdr.write(write_number(K_END))
        # UnpackInfo
        hdr.write(write_number(K_UNPACK_INFO))
        hdr.write(write_number(K_FOLDER))
        hdr.write(write_number(1))  # one folder
        hdr.write(b"\x00")  # not external
        hdr.write(write_number(1))  # one coder in the folder
        flags = len(coder.codec_id) | (0x20 if coder.props else 0)
        hdr.write(bytes([flags]))
        hdr.write(coder.codec_id)
        if coder.props:
            hdr.write(write_number(len(coder.props)))
            hdr.write(coder.props)
        hdr.write(write_number(K_CODERS_UNPACK_SIZE))
        hdr.write(write_number(len(payload)))
        hdr.write(write_number(K_END))
        # SubStreamsInfo
        hdr.write(write_number(K_SUBSTREAMS_INFO))
        hdr.write(write_number(K_NUM_UNPACK_STREAM))
        hdr.write(write_number(len(content_entries)))
        hdr.write(write_number(K_SIZE))
        for e in content_entries[:-1]:
            hdr.write(write_number(e.size))
        hdr.write(write_number(K_CRC))
        hdr.write(b"\x01")  # all defined
        for e in content_entries:
            hdr.write(struct.pack("<I", zlib.crc32(e.data) & 0xFFFFFFFF))
        hdr.write(write_number(K_END))
        hdr.write(write_number(K_END))
    # FilesInfo
    hdr.write(write_number(K_FILES_INFO))
    hdr.write(write_number(len(ordered)))
    if empty_entries:
        bits = _write_bits([e.is_dir or not e.data for e in ordered])
        hdr.write(write_number(K_EMPTY_STREAM))
        hdr.write(write_number(len(bits)))
        hdr.write(bits)
        empty_file_bits = [not e.is_dir for e in ordered if (e.is_dir or not e.data)]
        if any(empty_file_bits):
            bits = _write_bits(empty_file_bits)
            hdr.write(write_number(K_EMPTY_FILE))
            hdr.write(write_number(len(bits)))
            hdr.write(bits)
    names_blob = b"\x00" + "\x00".join(e.name.replace("/", "\\") for e in ordered).encode(
        "utf-16-le"
    ) + b"\x00\x00"
    hdr.write(write_number(K_NAMES))
    hdr.write(write_number(len(names_blob)))
    hdr.write(names_blob)
    attr_blob = b"\x01\x00" + b"".join(
        struct.pack(
            "<I",
            FILE_ATTRIBUTE_DIRECTORY if e.is_dir else FILE_ATTRIBUTE_ARCHIVE,
        )
        for e in ordered
    )
    hdr.write(write_number(K_ATTRIBUTES))
    hdr.write(write_number(len(attr_blob)))
    hdr.write(attr_blob)
    hdr.write(write_number(K_END))  # end FilesInfo
    hdr.write(write_number(K_END))  # end Header
    header = hdr.getvalue()

    # ---- optionally compress the header behind a kEncodedHeader record
    trailing = header
    if encode_header:
        h_dict = 1 << 20
        hcomp = lzma.LZMACompressor(
            format=lzma.FORMAT_RAW,
            filters=[dict(id=lzma.FILTER_LZMA2, preset=level, dict_size=h_dict)],
        )
        hpacked = hcomp.compress(header) + hcomp.flush()
        top = io.BytesIO()
        top.write(write_number(K_ENCODED_HEADER))
        # PackInfo: the packed header stream sits right after the payload
        top.write(write_number(K_PACK_INFO))
        top.write(write_number(len(packed)))  # pack pos
        top.write(write_number(1))
        top.write(write_number(K_SIZE))
        top.write(write_number(len(hpacked)))
        top.write(write_number(K_END))
        # UnpackInfo: one LZMA2 folder with a defined folder CRC
        top.write(write_number(K_UNPACK_INFO))
        top.write(write_number(K_FOLDER))
        top.write(write_number(1))
        top.write(b"\x00")  # not external
        top.write(write_number(1))  # one coder
        hprops = bytes([_lzma2_prop_byte(h_dict)])
        top.write(bytes([len(CODEC_LZMA2) | 0x20]))
        top.write(CODEC_LZMA2)
        top.write(write_number(len(hprops)))
        top.write(hprops)
        top.write(write_number(K_CODERS_UNPACK_SIZE))
        top.write(write_number(len(header)))
        top.write(write_number(K_CRC))
        top.write(b"\x01")  # all defined
        top.write(struct.pack("<I", zlib.crc32(header) & 0xFFFFFFFF))
        top.write(write_number(K_END))
        top.write(write_number(K_END))  # end StreamsInfo
        trailing = hpacked + top.getvalue()
        nh_offset = len(packed) + len(hpacked)
        nh_size = top.tell()
        nh_crc = zlib.crc32(top.getvalue()) & 0xFFFFFFFF
    else:
        nh_offset = len(packed)
        nh_size = len(header)
        nh_crc = zlib.crc32(header) & 0xFFFFFFFF

    # ---- assemble archive
    start = struct.pack("<QQI", nh_offset, nh_size, nh_crc)
    start_crc = zlib.crc32(start) & 0xFFFFFFFF
    w(MAGIC)
    w(bytes([0, 4]))  # version
    w(struct.pack("<I", start_crc))
    w(start)
    w(packed)
    w(trailing)
    return out.getvalue()


# ---------------------------------------------------------------- helpers
def pack_directory(
    folder: str,
    level: int = 1,
    store: bool = False,
    encode_header: bool = False,
) -> bytes:
    """Archive a directory tree (relative arcnames), like
    `7z a` / py7zr writeall in the reference."""
    entries = []
    for root, dirs, files in os.walk(folder):
        dirs.sort()
        for d in sorted(dirs):
            rel = os.path.relpath(os.path.join(root, d), folder)
            entries.append(Entry(name=rel.replace(os.sep, "/"), is_dir=True))
        for name in sorted(files):
            p = os.path.join(root, name)
            rel = os.path.relpath(p, folder)
            with open(p, "rb") as fh:
                entries.append(Entry(name=rel.replace(os.sep, "/"), data=fh.read()))
    return write_7z(entries, level=level, store=store, encode_header=encode_header)


def safe_join(out_dir: str, name: str) -> str:
    """Join an archive entry name to out_dir, rejecting absolute paths,
    drive letters, and '..' escapes (zip-slip).  Archive entries are
    untrusted external input (.gim files come from third parties)."""
    norm = name.replace("\\", "/")
    if norm.startswith("/") or re.match(r"^[A-Za-z]:", norm):
        raise ValueError(f"unsafe absolute archive entry name: {name!r}")
    base = os.path.realpath(out_dir)
    target = os.path.realpath(os.path.join(base, norm))
    if target != base and not target.startswith(base + os.sep):
        raise ValueError(f"archive entry escapes extraction dir: {name!r}")
    return target


def extract_to_directory(data: bytes, out_dir: str) -> list[str]:
    """Extract an archive to a directory; returns written paths."""
    written = []
    os.makedirs(out_dir, exist_ok=True)
    for e in read_7z(data):
        target = safe_join(out_dir, e.name)
        if e.is_dir:
            os.makedirs(target, exist_ok=True)
            continue
        os.makedirs(os.path.dirname(target) or out_dir, exist_ok=True)
        with open(target, "wb") as fh:
            fh.write(e.data or b"")
        written.append(target)
    return written
