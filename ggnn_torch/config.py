"""Graph geometry configuration for the GGNN search graph (PyTorch port).

A copy of the JAX package's ``config.py``: pure NumPy host math, so both packages
derive the same geometry from the same (N, D, KBuild).

Derives the entire hierarchical-graph geometry from three user parameters
(N, D, KBuild), mirroring the reference semantics of
`src/ggnn/base/graph_config.cpp:39-106` and
`include/ggnn/base/graph_config.h:32-111` (cgtuebingen/ggnn), re-expressed as
pure Python/NumPy host math.

The philosophy (kept from the reference): *two* user knobs -- KBuild and tau --
and everything else derived.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

__all__ = [
    "DistanceMeasure",
    "GraphConfig",
    "MIN_D",
    "MAX_D",
    "MIN_KBUILD",
    "MAX_KBUILD",
    "MAX_KQUERY",
    "next_multiple",
    "bit_ceil",
]

# Capability bounds (reference: include/ggnn/base/ggnn.cuh:47-52, README.md:133-141).
MIN_D = 1
MAX_D = 4096
MIN_KBUILD = 2
MAX_KBUILD = 512
MAX_KQUERY = 6000

# Traversal capacity constants (reference: merge_layer.cuh:40-41,
# sym_query_layer.cuh:37-38, query_kernels.cu:63-72). Here they size the
# per-row beam-state tensors rather than CUDA shared memory, but we keep the
# same defaults so quality/recall behavior matches.
MERGE_MAX_ITERATIONS = 200
MERGE_CACHE_SIZE = 256
SYM_MAX_PER_PATH_ITERATIONS = 20
SYM_CACHE_SIZE = 128
QUERY_MIN_PRIOQ_SIZE = 16
QUERY_MIN_VISITED_SIZE = 32
QUERY_MIN_CACHE_SIZE = 256
QUERY_MAX_CACHE_SIZE = 8192
MIN_PRIOQ_SIZE = 16


class DistanceMeasure(enum.IntEnum):
    """Distance measures (reference: include/ggnn/base/def.h:27-30)."""

    Euclidean = 0  # squared L2 internally; sqrt only for nn1 statistics
    Cosine = 1

    @classmethod
    def parse(cls, value) -> "DistanceMeasure":
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls[value.capitalize()]
        return cls(value)


def next_multiple(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m`` (reference: def.h)."""
    return ((x + m - 1) // m) * m


def bit_ceil(x: int) -> int:
    """Smallest power of two >= x (reference: def.h)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Derived geometry of one graph shard.

    The hierarchy has ``L=4`` layers (reference empirically found 4 layers to
    work best across datasets, graph_config.h:42-43). Layer 0 holds all N
    points; layer ``l`` holds ``Ns[l] = G^(L-1-l) * S`` points grouped in
    segments of size S. Each point stores KBuild neighbors; the last
    ``KF = KBuild//2`` slots hold inverse ("foreign") links.

    Derivation mirrors graph_config.cpp:39-106 exactly (including its float32
    arithmetic) so graphs built here are geometry-compatible with the
    reference.
    """

    # user parameters
    N: int
    D: int
    KBuild: int

    L: int = 4

    # derived parameters
    KF: int = 0
    G: int = 0
    S: int = 0
    S0: int = 0
    S0_off: int = 0
    SG: int = 0
    SG_off: int = 0

    # dimensions
    N_all: int = 0
    ST_all: int = 0
    Bs: tuple = ()
    Ns: tuple = ()
    Ns_offsets: tuple = ()
    STs_offsets: tuple = ()

    @staticmethod
    def create(N: int, D: int, KBuild: int) -> "GraphConfig":
        if not (MIN_D <= D <= MAX_D):
            raise ValueError(f"D={D} out of supported range [{MIN_D}, {MAX_D}]")
        if not (MIN_KBUILD <= KBuild <= MAX_KBUILD):
            raise ValueError(
                f"KBuild={KBuild} out of supported range [{MIN_KBUILD}, {MAX_KBUILD}]"
            )
        if N < 1:
            raise ValueError(f"N={N} must be positive")
        if N >= 2**31:
            raise ValueError(f"N={N} exceeds int32 key range")

        L = GraphConfig.L

        # graph_config.h:54,60
        KF = KBuild // 2
        S = next_multiple(KF + 1, 32)

        # graph_config.cpp:63-98 -- float32 math kept for bit-compatible
        # geometry decisions.
        growth = np.float32(N / np.float32(S)) ** np.float32(1.0 / (L - 1))
        Gf = int(growth)
        Gc = Gf + 1
        S0f = np.float32(N) / np.float32(np.float32(Gf) ** np.float32(L - 1.0))
        S0c = np.float32(N) / np.float32(np.float32(Gc) ** np.float32(L - 1.0))
        is_floor = (int(S0c) < KBuild) or (
            abs(S0f - np.float32(S)) < abs(S0c - np.float32(S))
        )
        G = Gf if is_floor else Gc
        S0 = int(S0f) if is_floor else int(S0c)
        S0_off = N - G ** (L - 1) * S0

        SG = S // G
        SG_off = S - SG * G

        if N < S:
            raise ValueError(f"N={N} must be at least the segment size S={S}")
        if S0 < KBuild:
            # The reference proceeds with partially-filled top-merge rows in
            # this regime (KBestList pads with EMPTY); later merge passes fill
            # the remaining slots, so this is only a quality warning.
            import warnings

            warnings.warn(
                f"base-layer segment size S0={S0} < KBuild={KBuild}: "
                "initial neighborhoods will be partially filled",
                stacklevel=2,
            )

        # graph_config.cpp:39-61 (GraphDimensions)
        Bs = [0] * L
        Ns = [0] * L
        B = 1
        for l in range(L - 1, -1, -1):
            Bs[l] = B
            Ns[l] = B * S
            B *= G
        Ns[0] = N

        Ns_offsets = [0] * L
        STs_offsets = [0] * L
        Ns_offsets[0] = 0
        STs_offsets[0] = 0
        if L > 1:
            STs_offsets[1] = 0
            Ns_offsets[1] = N
        for l in range(2, L):
            Ns_offsets[l] = Ns_offsets[l - 1] + Ns[l - 1]
            STs_offsets[l] = STs_offsets[l - 1] + Ns[l - 1]
        N_all = Ns_offsets[L - 1] + Ns[L - 1]
        ST_all = STs_offsets[L - 1] + Ns[L - 1]

        return GraphConfig(
            N=N,
            D=D,
            KBuild=KBuild,
            L=L,
            KF=KF,
            G=G,
            S=S,
            S0=S0,
            S0_off=S0_off,
            SG=SG,
            SG_off=SG_off,
            N_all=N_all,
            ST_all=ST_all,
            Bs=tuple(Bs),
            Ns=tuple(Ns),
            Ns_offsets=tuple(Ns_offsets),
            STs_offsets=tuple(STs_offsets),
        )

    # --- traversal capacity geometry -------------------------------------

    @property
    def KL(self) -> int:
        """Number of local (non-foreign) links per point."""
        return self.KBuild - self.KF

    def merge_beam_geometry(self) -> tuple[int, int]:
        """(beam width, visited-ring size) for the hierarchical merge search.

        The reference keeps BEST=KBuild+1 results plus a priority queue in a
        SORTED region of max(64, next32(KBuild+1+16)) shared-memory slots and
        a visited ring filling the rest of CACHE_SIZE=256
        (merge_layer.cuh:40-41,64-65); the flagged beam is the sorted region,
        the ring is id-only dedup history."""
        sorted_size = max(
            64 if MERGE_CACHE_SIZE < 512 else 32,
            next_multiple(self.KBuild + 1 + MIN_PRIOQ_SIZE, 32),
        )
        cache = max(MERGE_CACHE_SIZE, sorted_size + QUERY_MIN_VISITED_SIZE)
        return sorted_size, cache - sorted_size

    def sym_beam_geometry(self) -> tuple[int, int]:
        """(beam width, visited-ring size) for the inverse-link walk.

        Mirrors sym_query_layer.cuh:37-38,58-59: BEST=KF,
        SORTED=max(64, next32(KF+16)), CACHE=128."""
        sorted_size = max(
            64 if SYM_CACHE_SIZE < 512 else 32,
            next_multiple(self.KF + MIN_PRIOQ_SIZE, 32),
        )
        cache = max(SYM_CACHE_SIZE, sorted_size + QUERY_MIN_VISITED_SIZE)
        return sorted_size, cache - sorted_size

    @staticmethod
    def query_beam_geometry(KQuery: int, max_iterations: int) -> tuple[int, int]:
        """(beam width, visited-ring size) for the ANN query.

        Mirrors the reference's sizing (query_kernels.cu:54-110):
        required=next32(KQuery+1+16), cache=max(256, required+32,
        bit_ceil(max_iters)) <= 8192, sorted=max(64 if cache<512 else 32,
        required); the ring gets cache - sorted slots."""
        if KQuery > MAX_KQUERY:
            raise ValueError(f"KQuery={KQuery} exceeds maximum {MAX_KQUERY}")
        required_sorted = next_multiple(KQuery + 1 + QUERY_MIN_PRIOQ_SIZE, 32)
        cache = max(
            QUERY_MIN_CACHE_SIZE,
            required_sorted + QUERY_MIN_VISITED_SIZE,
            bit_ceil(max_iterations),
        )
        if cache > QUERY_MAX_CACHE_SIZE:
            cache = QUERY_MAX_CACHE_SIZE
        sorted_size = max(64 if cache < 512 else 32, required_sorted)
        return sorted_size, cache - sorted_size

    # --- segment helpers ---------------------------------------------------

    def layer_segment_size(self, layer: int) -> int:
        """Regular segment size at ``layer`` (S0 at layer 0, else S)."""
        return self.S if layer else self.S0

    def layer_segment_offset_count(self, layer: int) -> int:
        """Number of leading segments holding one extra point."""
        return 0 if layer else self.S0_off

    def describe(self) -> str:
        return (
            f"GraphConfig(): N: {self.N}, K: {self.KBuild}, KF: {self.KF}, "
            f"L: {self.L}, G: {self.G}, S: {self.S}, S0: {self.S0}, "
            f"S0_off: {self.S0_off}, SG: {self.SG}, SG_off: {self.SG_off}"
        )

    def graph_size_bytes(self) -> int:
        """Total serialized graph payload (neighbors + selection/translation
        + nn1 stats), mirroring graph.h:38-55."""
        return self.N_all * self.KBuild * 4 + 2 * self.ST_all * 4 + 8

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
