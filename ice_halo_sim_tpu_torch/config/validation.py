"""Raypath / face-number validation.

Mirrors the reference's raypath validation layer
(reference/src/config/raypath_validation.hpp and
src/core/crystal.cpp IsLegalFace): face-number legality per crystal kind
and syntax validation for user-entered raypath text. Pure stdlib — used by
config loading and any front-end input gating.

Legal face-number sets for the hexagonal crystal family:
  basal:          1, 2
  prism lateral:  3..8
  upper pyramid: 13..18
  lower pyramid: 23..28
"""

from __future__ import annotations

import enum
import re
from typing import Optional, Tuple


class CrystalKind(enum.Enum):
    PRISM = "prism"
    PYRAMID = "pyramid"


class RaypathValidation(enum.Enum):
    VALID = "valid"            # safe to submit
    INCOMPLETE = "incomplete"  # trailing/leading separator; still typing
    INVALID = "invalid"        # non-numeric or empty interior tokens


_BASAL = frozenset({1, 2})
_PRISM_LATERAL = frozenset(range(3, 9))
_UPPER_PYRAMID = frozenset(range(13, 19))
_LOWER_PYRAMID = frozenset(range(23, 29))
ALL_LEGAL_FACES = _BASAL | _PRISM_LATERAL | _UPPER_PYRAMID | _LOWER_PYRAMID

_LEGAL = {
    CrystalKind.PRISM: _BASAL | _PRISM_LATERAL,
    CrystalKind.PYRAMID: ALL_LEGAL_FACES,
}


def is_legal_face(kind: CrystalKind, face: int) -> bool:
    """Face-number legality per crystal kind (crystal.cpp:43-56)."""
    return int(face) in _LEGAL[kind]


def legal_faces(kind: CrystalKind) -> frozenset:
    return _LEGAL[kind]


_SEP = re.compile(r"[-,]")


def validate_raypath_text(
    text: str, kind: Optional[CrystalKind] = None
) -> Tuple[RaypathValidation, str]:
    """Validate dash/comma-separated face indices.

    Rules in priority order (raypath_validation.hpp:29-58):
      empty -> VALID ("no raypath filter"); consecutive separators ->
      INVALID; non-numeric token -> INVALID; trailing separator ->
      INCOMPLETE; leading separator -> INCOMPLETE; else VALID. With a
      ``kind``, tokens are then checked against the global legal union and
      the kind-specific set; the first offender produces the message.
    """
    text = text.strip()
    if not text:
        return RaypathValidation.VALID, ""

    tokens = _SEP.split(text)
    # Consecutive separators produce an empty interior token.
    if any(t == "" for t in tokens[1:-1]):
        return RaypathValidation.INVALID, "Invalid raypath"
    if len(tokens) >= 2 and tokens[0] == "" and tokens[-1] == "":
        return RaypathValidation.INVALID, "Invalid raypath"
    for t in tokens:
        if t != "" and not t.isdigit():
            return RaypathValidation.INVALID, "Invalid raypath"
    if tokens[-1] == "":
        return RaypathValidation.INCOMPLETE, ""
    if tokens[0] == "":
        return RaypathValidation.INCOMPLETE, ""

    if kind is not None:
        for t in tokens:
            face = int(t)
            if face not in ALL_LEGAL_FACES:
                return (
                    RaypathValidation.INVALID,
                    f"Face {face} is outside the legal range of any crystal",
                )
        for t in tokens:
            face = int(t)
            if not is_legal_face(kind, face):
                return (
                    RaypathValidation.INVALID,
                    f"Face {face} is not legal on this crystal type "
                    f"({kind.value.capitalize()})",
                )
    return RaypathValidation.VALID, ""


def parse_raypath(text: str) -> Tuple[int, ...]:
    """Parse a VALID raypath text into a face-number tuple."""
    state, msg = validate_raypath_text(text)
    if state != RaypathValidation.VALID:
        raise ValueError(msg or f"raypath text not valid: {text!r}")
    text = text.strip()
    if not text:
        return ()
    return tuple(int(t) for t in _SEP.split(text))
