"""CBM/FAM model-tree parser and BLHA write-back.

Copy of ``pointcloudhookup_tpu/io/cbm.py``.  The GIM payload is a tree of
UTF-8 ``key=value`` text files under ``Cbm/``.  Parsing semantics mirror
the reference's GIMTower (its ui/parsetower.py:17-114):

  * ``Cbm/project.cbm`` lists subsystems via ``SUBSYSTEM=<file>``;
  * each ``.cbm`` may carry ``ENTITYNAME=``, ``GROUPTYPE=`` (value
    ``TOWER`` marks a tower record), ``BLHA=lat,lng,h,r``,
    ``BASEFAMILY=<fam>`` (a ``.fam`` of ``_=key=value`` lines becomes the
    record's properties), ``TOWER=<sub.cbm>`` (properties come from the
    sub-tree's BASEFAMILY), and counted child lists introduced by
    ``SECTIONS.NUM=``/``STRAINSECTIONS.NUM=``/``GROUPS.NUM=`` whose
    following N lines are ``KEY=<child.cbm>`` entries;
  * files are visited at most once; records are deduplicated by path.

Write-back mirrors CBMUpdater (the reference's ui/save_cbm.py:18-66,
209-236): replace (or append) the ``BLHA=`` line with
``BLHA={lat:.6f},{lon:.6f},{height:.3f},{rotation:.3f}`` and locate CBM
files by stored path or tower-id filename heuristics.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

TOWER_GROUP = "TOWER"


@dataclasses.dataclass
class GimTowerRecord:
    """One tower parsed from the GIM tree (reference node dict shape)."""

    name: str = ""
    type: str = ""
    lng: float = 0.0
    lat: float = 0.0
    h: float = 0.0
    r: float = 0.0
    properties: Optional[dict] = None
    cbm_path: str = ""

    def get(self, key, default=None):
        """Dict-style access so matching code can treat records like the
        reference's node dicts."""
        return getattr(self, key, default)


class CbmParser:
    def __init__(self, gim_folder: str, log: Optional[Callable[[str], None]] = None):
        self.gim_folder = gim_folder
        self.cbm_root = os.path.join(gim_folder, "Cbm")
        self.log = log or (lambda msg: None)
        self.towers: list[GimTowerRecord] = []
        self.visited: set[str] = set()
        self.cbm_files: list[str] = []

    def parse(self) -> list[GimTowerRecord]:
        project = os.path.join(self.cbm_root, "project.cbm")
        try:
            with open(project, "r", encoding="utf-8") as f:
                for line in f:
                    if line.startswith("SUBSYSTEM="):
                        sub = line.split("=", 1)[1].strip()
                        self._parse_cbm(os.path.join(self.cbm_root, sub))
        except OSError as e:
            self.log(f"project.cbm parse failed: {e}")
        # dedup by cbm_path, first wins (ref: parsetower.py:143-151)
        seen = set()
        unique = []
        for t in self.towers:
            if t.cbm_path not in seen:
                unique.append(t)
                seen.add(t.cbm_path)
        self.towers = unique
        return self.towers

    def _parse_cbm(self, cbm_path: str, is_family_probe: bool = False):
        if cbm_path in self.visited:
            return None
        self.visited.add(cbm_path)
        if cbm_path not in self.cbm_files:
            self.cbm_files.append(cbm_path)
        node = GimTowerRecord(cbm_path=cbm_path)
        try:
            with open(cbm_path, "r", encoding="utf-8") as f:
                for line in f:
                    if line.startswith("ENTITYNAME="):
                        node.name = line.split("=", 1)[1].strip()
                    elif line.startswith("GROUPTYPE="):
                        if line.split("=", 1)[1].strip() == TOWER_GROUP:
                            node.type = TOWER_GROUP
                            self.towers.append(node)
                    elif line.startswith("BLHA="):
                        parts = line.split("=", 1)[1].replace(",", " ").split()
                        vals = [float(x) for x in parts[:4]]
                        node.lat, node.lng, node.h, node.r = vals
                    elif line.startswith("BASEFAMILY="):
                        fam = line.split("=", 1)[1].strip()
                        if not fam:
                            continue
                        props = self._parse_fam(os.path.join(self.cbm_root, fam))
                        if is_family_probe:
                            return props
                        node.properties = props
                    if line.startswith("TOWER="):
                        sub = line.split("=", 1)[1].strip()
                        node.properties = self._parse_cbm(
                            os.path.join(self.cbm_root, sub), True
                        )
                    for key in ("SECTIONS.NUM=", "STRAINSECTIONS.NUM=", "GROUPS.NUM="):
                        if line.startswith(key):
                            num = int(line.split("=", 1)[1].strip())
                            for _ in range(num):
                                child = next(f).split("=", 1)[1].strip()
                                self._parse_cbm(os.path.join(self.cbm_root, child))
        except FileNotFoundError:
            pass
        except (OSError, ValueError, StopIteration) as e:
            self.log(f"cbm parse error in {cbm_path}: {e}")
        return None

    def _parse_fam(self, fam_path: str) -> Optional[dict]:
        props = {}
        try:
            with open(fam_path, "r", encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("=")
                    if len(parts) != 3:
                        continue
                    props[parts[1].strip()] = parts[2].strip()
            return props
        except OSError:
            return None


def load_towers_from_gim_folder(gim_folder: str, log=None) -> list[GimTowerRecord]:
    return CbmParser(gim_folder, log).parse()


# ------------------------------------------------------------ write-back
BLHA_FORMAT = "BLHA={lat:.6f},{lon:.6f},{height:.3f},{rotation:.3f}\n"


def update_cbm_blha(cbm_file_path: str, lat, lon, height, rotation) -> bool:
    """Rewrite (or append) the BLHA= line of one CBM file
    (ref: save_cbm.py:18-66, exact number formatting)."""
    if not os.path.exists(cbm_file_path):
        return False
    with open(cbm_file_path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    new_line = BLHA_FORMAT.format(
        lat=float(lat), lon=float(lon), height=float(height), rotation=float(rotation)
    )
    found = False
    out = []
    for line in lines:
        if line.startswith("BLHA="):
            out.append(new_line)
            found = True
        else:
            out.append(line)
    if not found:
        out.append(new_line)
    with open(cbm_file_path, "w", encoding="utf-8") as f:
        f.writelines(out)
    return True


def find_cbm_for_tower(cbm_folder: str, tower_id: str) -> list[str]:
    """Filename heuristics for locating a tower's CBM when no stored path
    is available (ref: save_cbm.py:214-224)."""
    candidates = [
        os.path.join(cbm_folder, f"{tower_id}.cbm"),
        os.path.join(cbm_folder, f"tower_{tower_id}.cbm"),
        os.path.join(cbm_folder, f"T{tower_id}.cbm"),
    ]
    for root, _dirs, files in os.walk(cbm_folder):
        for name in files:
            if name.endswith(".cbm") and tower_id and tower_id in name:
                candidates.append(os.path.join(root, name))
    return candidates


def apply_corrections(
    gim_folder: str,
    corrected: list[dict],
    log: Optional[Callable[[str], None]] = None,
) -> int:
    """Update BLHA lines for a list of corrected tower dicts with keys
    (or Chinese-header aliases, matching the reference's table schema):
    tower_id/杆塔编号, lat/纬度, lon/经度, height/高度, rotation/北方向偏角,
    cbm_path/CBM路径.  Returns the number of CBM files updated."""
    log = log or (lambda m: None)
    cbm_folder = os.path.join(gim_folder, "Cbm")
    updated = 0
    for row in corrected:
        tower_id = str(row.get("tower_id", row.get("杆塔编号", "")))
        lat = float(row.get("lat", row.get("纬度", 0)))
        lon = float(row.get("lon", row.get("经度", 0)))
        height = float(row.get("height", row.get("高度", 0)))
        rotation = float(row.get("rotation", row.get("北方向偏角", 0)))
        cbm_path = row.get("cbm_path", row.get("CBM路径", ""))
        if cbm_path and os.path.exists(cbm_path):
            if update_cbm_blha(cbm_path, lat, lon, height, rotation):
                updated += 1
                continue
        done = False
        for cand in find_cbm_for_tower(cbm_folder, tower_id):
            if os.path.exists(cand) and update_cbm_blha(cand, lat, lon, height, rotation):
                updated += 1
                done = True
                break
        if not done:
            log(f"no CBM file found for tower {tower_id}")
    return updated
