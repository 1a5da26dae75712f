"""ID model and triple model.

Mirrors the reference's type system (core/type.hpp:28-127, core/store/vertex.hpp:34-43,
datagen/generate_data.cpp:50-52):

- ``sid`` (string id): unsigned vertex/predicate/type id. We use int64 host-side and
  int32 on device (LUBM-10240 has ~1.4B triples but < 2^31 vertices).
- ``ssid`` (signed string id): query-side id — variables are NEGATIVE, constants
  POSITIVE (core/type.hpp:31).
- The id space is split: ids < 2^NBITS_IDX (= 2^17) are *index* ids (predicates and
  types); ids >= 2^17 are *normal* vertices (datagen/generate_data.cpp:50, 117-123).
- Reserved index ids: PREDICATE_ID=0 (``__PREDICATE__`` — the predicate index),
  TYPE_ID=1 (``rdf:type`` — the type index) (core/store/vertex.hpp:34-43).
- BLANK_ID marks OPTIONAL-unmatched cells in binding tables (core/type.hpp:33).

Directions (core/type.hpp:127): IN=0, OUT=1. A triple (s, p, o) is reachable both as
(s, p, OUT) -> o and (o, p, IN) -> s; the store indexes both.
"""

from __future__ import annotations

import enum

import numpy as np

# ---------------------------------------------------------------------------
# Reserved ids and id-space split
# ---------------------------------------------------------------------------

PREDICATE_ID = 0  # "__PREDICATE__" — predicate-index id
TYPE_ID = 1  # rdf:type — type-index id
NBITS_IDX = 17  # ids < 2**NBITS_IDX are index (predicate/type) ids
NORMAL_ID_START = 1 << NBITS_IDX

# Device arrays are int32; BLANK_ID is the max unsigned 32-bit value in the
# reference (core/type.hpp:33). We keep tables as int32 on device, so BLANK_ID
# maps to -1 (all-ones); host-side code treats both views equivalently.
BLANK_ID = (1 << 32) - 1  # uint32 view (reference value)
BLANK_ID_I32 = -1  # int32 device view (same bit pattern)

# dtypes
SID_DTYPE = np.int64  # host-side id arrays (room for 64-bit build)
DEVICE_SID_DTYPE = np.int32  # device-side binding tables / CSR arrays


class Dir(enum.IntEnum):
    """Edge direction (core/type.hpp:127). CORUN is an optimizer hint."""

    IN = 0
    OUT = 1
    CORUN = 2


IN = Dir.IN
OUT = Dir.OUT
CORUN = Dir.CORUN


# ---------------------------------------------------------------------------
# Attribute value types (utils/variant.hpp:28-50)
# ---------------------------------------------------------------------------


class AttrType(enum.IntEnum):
    SID_t = 0
    INT_t = 1
    FLOAT_t = 2
    DOUBLE_t = 3


# ---------------------------------------------------------------------------
# ssid helpers: variables are negative, constants positive
# ---------------------------------------------------------------------------


def is_tpid(ssid: int) -> bool:
    """'type or predicate id': inside the index space, excluding the reserved
    PREDICATE_ID/TYPE_ID slots (core/store/vertex.hpp:41: id > 1 && id < 2^17)."""
    return 1 < ssid < NORMAL_ID_START
