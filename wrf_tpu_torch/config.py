"""Configuration system: the WRF namelist record and its projections.

Two-tier design mirroring the reference (SURVEY.md §5 'Config / flag
system'):

  1. :class:`GridConfigRecord` — the full WRF namelist record.  The schema
     (1,796 field names/types, reference: module_configure.f90:3-1800) lives
     in ``config_schema.json``, extracted by ``tools/gen_config_schema.py``;
     the record supports attribute access, a binary one-blob codec matching
     the Fortran stream dump the reference driver consumes
     (advance_mu_t_driver.f90:70-72), and per-flag binary files
     (advance_mu_t_driver.c:135-137).
  2. :class:`ConfigFlags26` — the 26-int C projection (config_flags.h:4-31).
  3. :class:`~wrf_tpu_torch.grid.ConfigFlags` — the 3 flags the dynamics kernel
     actually consumes (periodic_x / specified / nested,
     advance_mu_t.c:90-99).

Projection direction: record -> 26-int struct -> 3-flag kernel view.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path

import numpy as np

from .grid import ConfigFlags

_SCHEMA_PATH = Path(__file__).resolve().parent / "config_schema.json"
_SCHEMA = json.loads(_SCHEMA_PATH.read_text())

RECORD_FIELDS: list[dict] = _SCHEMA["record_fields"]
C_PROJECTION_FIELDS: list[str] = _SCHEMA["c_projection"]

_DEFAULTS = {"int": 0, "float": 0.0, "bool": False, "str": ""}
_CHAR_LEN = 256  # Fortran character*256


class GridConfigRecord:
    """The full WRF namelist record, schema-driven.

    Unknown attribute names raise; types are coerced on set.  The binary
    blob codec writes fields in declaration order, big-endian 4-byte
    int/real/logical and 256-byte space-padded character — the layout of a
    Fortran ``ACCESS="STREAM", convert="big_endian"`` record dump.
    """

    __slots__ = ("_values",)

    _types = {f["name"]: f["type"] for f in RECORD_FIELDS}

    def __init__(self, **overrides):
        object.__setattr__(self, "_values", {
            f["name"]: _DEFAULTS[f["type"]] for f in RECORD_FIELDS
        })
        for name, value in overrides.items():
            setattr(self, name, value)

    def __getattr__(self, name: str):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"unknown namelist field {name!r}") from None

    def __setattr__(self, name: str, value) -> None:
        ftype = self._types.get(name)
        if ftype is None:
            raise AttributeError(f"unknown namelist field {name!r}")
        caster = {"int": int, "float": float, "bool": bool, "str": str}[ftype]
        self._values[name] = caster(value)

    def __eq__(self, other) -> bool:
        return isinstance(other, GridConfigRecord) and self._values == other._values

    def __len__(self) -> int:
        return len(self._values)

    # ------------------------------------------------------------------ #
    # projections
    # ------------------------------------------------------------------ #
    def kernel_flags(self) -> ConfigFlags:
        """The 3-flag view the dynamics kernel consumes."""
        return ConfigFlags(
            nested=bool(self.nested),
            periodic_x=bool(self.periodic_x),
            specified=bool(self.specified),
        )

    def c_projection(self) -> "ConfigFlags26":
        return ConfigFlags26(**{
            name: int(self._values[name]) for name in C_PROJECTION_FIELDS
        })

    # ------------------------------------------------------------------ #
    # binary blob codec
    # ------------------------------------------------------------------ #
    def to_blob(self) -> bytes:
        parts = []
        for f in RECORD_FIELDS:
            v = self._values[f["name"]]
            if f["type"] == "int":
                parts.append(struct.pack(">i", v))
            elif f["type"] == "float":
                parts.append(struct.pack(">f", v))
            elif f["type"] == "bool":
                # Fortran LOGICAL: 4 bytes, .TRUE. = 1
                parts.append(struct.pack(">i", 1 if v else 0))
            else:
                parts.append(v.encode("ascii", "replace")[:_CHAR_LEN]
                             .ljust(_CHAR_LEN, b" "))
        return b"".join(parts)

    @classmethod
    def from_blob(cls, blob: bytes) -> "GridConfigRecord":
        rec = cls()
        off = 0
        for f in RECORD_FIELDS:
            if f["type"] == "int":
                rec._values[f["name"]] = struct.unpack_from(">i", blob, off)[0]
                off += 4
            elif f["type"] == "float":
                rec._values[f["name"]] = struct.unpack_from(">f", blob, off)[0]
                off += 4
            elif f["type"] == "bool":
                rec._values[f["name"]] = bool(struct.unpack_from(">i", blob, off)[0])
                off += 4
            else:
                raw = blob[off : off + _CHAR_LEN]
                rec._values[f["name"]] = raw.decode("ascii", "replace").rstrip()
                off += _CHAR_LEN
        return rec

    def save(self, path) -> None:
        Path(path).write_bytes(self.to_blob())

    @classmethod
    def load(cls, path) -> "GridConfigRecord":
        return cls.from_blob(Path(path).read_bytes())

    def to_overrides(self) -> dict:
        """The fields that differ from schema defaults — the compact JSON
        form ``run_sim --namelist`` accepts."""
        return {f["name"]: self._values[f["name"]] for f in RECORD_FIELDS
                if self._values[f["name"]] != _DEFAULTS[f["type"]]}


# ---------------------------------------------------------------------- #
# Fortran namelist text front end
# ---------------------------------------------------------------------- #
# The reference consumes its config record as a binary Fortran stream blob
# (advance_mu_t_driver.f90:70-72), but upstream WRF populates that record
# from a text ``namelist.input`` file — the file an actual WRF user edits.
# This parser accepts that format directly so a namelist.input drives the
# framework without a conversion step.

_NML_GROUP = re.compile(r"&(\w+)", re.ASCII)
_NML_ASSIGN = re.compile(r"([A-Za-z_]\w*)\s*=", re.ASCII)
_NML_REPEAT = re.compile(r"^(\d+)\*(.*)$", re.ASCII | re.DOTALL)


def _nml_strip_comment(line: str) -> str:
    """Drop a trailing ``!`` comment, ignoring ``!`` inside quotes."""
    quote = None
    for pos, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "!":
            return line[:pos]
    return line


def _nml_scalar(tok: str):
    """Parse one namelist token: logical, int, real (incl. ``1.d-5``),
    or quoted/bare string."""
    if len(tok) >= 2 and tok[0] in "'\"" and tok[-1] == tok[0]:
        return tok[1:-1]
    low = tok.lower()
    if low in (".true.", ".t.", "t", "true"):
        return True
    if low in (".false.", ".f.", "f", "false"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        # Fortran double-precision exponent: 1.5d-3 -> 1.5e-3
        return float(low.replace("d", "e"))
    except ValueError:
        return tok  # bare (unquoted) string


def _nml_values(raw: str) -> list:
    """Split a namelist RHS into parsed values (comma- and/or
    space-separated; ``n*value`` Fortran repetition expanded)."""
    toks: list[str] = []
    quote = None
    cur = ""
    for ch in raw:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == "," or ch.isspace():
            if cur:
                toks.append(cur)
                cur = ""
        else:
            cur += ch
    if cur:
        toks.append(cur)
    out = []
    for tok in toks:
        m = _NML_REPEAT.match(tok)
        if m and m.group(2):
            out.extend([_nml_scalar(m.group(2))] * int(m.group(1)))
        else:
            out.append(_nml_scalar(tok))
    return out


def parse_namelist_text(text: str) -> dict:
    """Parse Fortran namelist text into ``{group: {name: [values...]}}``.

    Handles ``&group`` … ``/`` blocks, ``!`` comments, quoted strings,
    logicals (``.true./.false./T/F``), ``d``-exponent reals, ``n*value``
    repetition, and multi-line / multi-column (per-domain) value lists.
    Repeated groups merge; repeated names within a group keep the last
    assignment (Fortran semantics).
    """
    groups: dict = {}
    group = None
    body: list[str] = []

    def flush():
        nonlocal body
        if group is None or not body:
            body = []
            return
        blob = " ".join(body)
        body = []
        sites = list(_NML_ASSIGN.finditer(blob))
        g = groups.setdefault(group, {})
        for n, m in enumerate(sites):
            end = sites[n + 1].start() if n + 1 < len(sites) else len(blob)
            g[m.group(1).lower()] = _nml_values(blob[m.end():end])

    for line in text.splitlines():
        line = _nml_strip_comment(line).strip()
        if not line:
            continue
        while line:
            if group is None:
                m = _NML_GROUP.search(line)
                if not m:
                    break  # stray text outside any group
                group = m.group(1).lower()
                line = line[m.end():]
            else:
                # a group ends at an unquoted "/"
                quote = None
                cut = None
                for pos, ch in enumerate(line):
                    if quote:
                        if ch == quote:
                            quote = None
                    elif ch in "'\"":
                        quote = ch
                    elif ch == "/":
                        cut = pos
                        break
                if cut is None:
                    body.append(line)
                    line = ""
                else:
                    body.append(line[:cut])
                    flush()
                    group = None
                    line = line[cut + 1:]
    flush()  # unterminated trailing group: accept what was read
    return groups


def read_namelist(source, strict: bool = False,
                  domain: int = 0) -> "GridConfigRecord":
    """Build a :class:`GridConfigRecord` from WRF ``namelist.input`` text.

    ``source`` is a path or raw namelist text (anything containing a
    newline or ``&`` is treated as text).  Entry names are matched against
    the record schema across ALL groups; per-domain value columns collapse
    to column ``domain`` (clamped to the list length — WRF reuses the last
    column for higher domains).  Unknown entry names are skipped unless
    ``strict`` (upstream WRF namelists carry registry entries beyond the
    reference's record, module_configure.f90:3-1800).
    """
    src = str(source)
    text = src if ("\n" in src or "&" in src) else Path(src).read_text()
    rec = GridConfigRecord()
    unknown = []
    for entries in parse_namelist_text(text).values():
        for name, values in entries.items():
            if name not in GridConfigRecord._types:
                unknown.append(name)
                continue
            if not values:
                continue
            setattr(rec, name, values[min(domain, len(values) - 1)])
    if strict and unknown:
        raise AttributeError(
            f"unknown namelist fields: {sorted(set(unknown))}")
    return rec


def dynamics_params(record: "GridConfigRecord") -> dict:
    """Map the namelist record onto the acoustic-loop parameters.

    WRF's small step is configured through the namelist (dyn_em section):
    ``epssm`` (vertical off-centering), ``smdiv`` (divergence damping),
    ``time_step`` / ``time_step_sound`` (the acoustic substep length
    dts = dt/ns), ``dx``/``dy`` (rdx = 1/dx).  The reference consumes only
    three BC flags from its 1,796-field record; this helper makes the rest
    of the dynamics group drive the framework's loop directly.

    Returns kwargs for the drivers / ``SmallStepLoop``:
    ``dict(rdx, rdy, dts, epssm, smdiv, acoustic_steps, flags)``.
    """
    dx = float(record.dx) or 1.0
    dy = float(record.dy) or dx
    ns = int(record.time_step_sound) or 4
    dt = float(record.time_step) or float(ns)
    return dict(
        rdx=1.0 / dx,
        rdy=1.0 / dy,
        dts=dt / ns,
        epssm=float(record.epssm),
        smdiv=float(record.smdiv),
        acoustic_steps=ns,
        flags=record.kernel_flags(),
    )


class ConfigFlags26:
    """The 26-int C projection of the namelist record
    (reference: config_flags.h:4-31): lateral-BC flags, advection orders and
    physics-option selectors.  Only nested/periodic_x/specified alter the
    advance_mu_t kernel."""

    __slots__ = tuple(C_PROJECTION_FIELDS)

    def __init__(self, **values):
        for name in C_PROJECTION_FIELDS:
            setattr(self, name, int(values.get(name, 0)))

    def __eq__(self, other) -> bool:
        return isinstance(other, ConfigFlags26) and all(
            getattr(self, n) == getattr(other, n) for n in C_PROJECTION_FIELDS
        )

    def kernel_flags(self) -> ConfigFlags:
        return ConfigFlags(
            nested=bool(self.nested),
            periodic_x=bool(self.periodic_x),
            specified=bool(self.specified),
        )

    # one-file-per-flag binary io (advance_mu_t_driver.c:135-137)
    def save_flag_files(self, directory, prefix: str = "config_flags_") -> None:
        from .io import codec
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        for name in C_PROJECTION_FIELDS:
            codec.write_int(d / f"{prefix}{name}.bin", getattr(self, name))

    @classmethod
    def load_flag_files(cls, directory, prefix: str = "config_flags_",
                        missing_ok: bool = True) -> "ConfigFlags26":
        from .io import codec
        d = Path(directory)
        values = {}
        for name in C_PROJECTION_FIELDS:
            p = d / f"{prefix}{name}.bin"
            if p.exists():
                values[name] = codec.read_int(p)
            elif not missing_ok:
                raise FileNotFoundError(p)
        return cls(**values)


# ---------------------------------------------------------------------- #
# converter CLI: every config format the ecosystem uses, from any input
# ---------------------------------------------------------------------- #
def load_any(source, strict: bool = False, domain: int = 0) -> GridConfigRecord:
    """Load a :class:`GridConfigRecord` from a path of any supported
    format, auto-detected: ``.json``/``{``-leading text → JSON override
    dict; text containing ``&group`` → Fortran namelist; otherwise the
    big-endian Fortran stream blob."""
    raw = Path(source).read_bytes()
    try:
        text = raw.decode("ascii")
    except UnicodeDecodeError:
        return GridConfigRecord.from_blob(raw)
    if text.lstrip().startswith("{"):
        return GridConfigRecord(**json.loads(text))
    if _NML_GROUP.search(text):
        return read_namelist(text, strict=strict, domain=domain)
    return GridConfigRecord.from_blob(raw)


def main(argv=None) -> int:
    """``python -m wrf_tpu_torch.config IN [--json P] [--blob P] [--flag-files D]``

    Convert between the config formats: WRF ``namelist.input`` text /
    JSON override dict / Fortran stream blob in; JSON overrides, blob
    (advance_mu_t_driver.f90:70-72's layout), or per-flag binary files
    (advance_mu_t_driver.c:135-137's layout) out.  With no output flag,
    prints the JSON override dict to stdout.
    """
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    p.add_argument("input", help="namelist.input text, JSON dict, or blob")
    p.add_argument("--json", default=None, metavar="PATH")
    p.add_argument("--blob", default=None, metavar="PATH")
    p.add_argument("--flag-files", default=None, metavar="DIR",
                   help="write the 26-int projection as per-flag .bins")
    p.add_argument("--domain", type=int, default=0,
                   help="per-domain namelist column to read (0-based)")
    p.add_argument("--strict", action="store_true",
                   help="error on namelist entries unknown to the record")
    args = p.parse_args(argv)

    rec = load_any(args.input, strict=args.strict, domain=args.domain)
    wrote = False
    if args.json:
        Path(args.json).write_text(json.dumps(rec.to_overrides(), indent=1)
                                   + "\n")
        wrote = True
    if args.blob:
        rec.save(args.blob)
        wrote = True
    if args.flag_files:
        rec.c_projection().save_flag_files(args.flag_files)
        wrote = True
    if not wrote:
        print(json.dumps(rec.to_overrides(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
