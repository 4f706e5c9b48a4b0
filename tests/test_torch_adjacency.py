"""The port's adjacency fetch+dot against the JAX package's.

``adjacency_dot_plain`` (the CPU route and the oracle of the CUDA kernel) is
held against the JAX gather+einsum oracle and against the Pallas kernel run
in interpret mode, on the same numpy inputs. Lanes of -1 anchors are
undefined in every implementation, so only live lanes are compared:
rtol 1e-5 / atol 1e-2, for the f32 summation order. The CUDA kernel itself
is compared with the plain version on the card only; the JAX package is
imported inside the CPU tests, so that the card-only tests also run where
JAX is not installed::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_adjacency.py

The kernel turns codes into floats without the int -> float conversion
unit (a byte moved into the mantissa of 2^23, then 2^23 subtracted); the
numpy tests here pin that this arithmetic is exact, which is why the
kernel's results need no looser tolerance than the f32 summation order.

Code rows whose width D is a multiple of 4 but not of 16 (GloVe's 100) take
the tail kernels, which read 4-byte words. On the card every kernel is also
held bit for bit: against the plain version where the queries are small
integers (every sum is then exact, in any order), and against
:func:`_kernel_order`, the plain version summed in the kernel's own order
(each lane's bytes in sequence, then a butterfly over the row's lanes),
where they are not.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ggnn_torch.ops import adjacency
from ggnn_torch.ops.adjacency import adjacency_dot, adjacency_dot_plain
from torch_reference import one_torch_thread  # noqa: F401


def _inputs(seed, B, P, CR, D, N, nibbles):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(B, D)).astype(np.float32)
    anchors = rng.integers(-1, N, size=(B, P)).astype(np.int32)
    if nibbles:
        c4 = rng.integers(0, 16, size=(N, 2 * CR, D)).astype(np.uint8)
        blocks = c4[:, 0::2, :] | (c4[:, 1::2, :] << 4)
    else:
        blocks = rng.integers(0, 256, size=(N, CR, D)).astype(np.uint8)
    return qs, anchors, blocks


def _assert_live_close(out, ref, anchors):
    valid = (anchors >= 0)[:, :, None]
    np.testing.assert_allclose(
        np.where(valid, out, 0.0), np.where(valid, ref, 0.0), rtol=1e-5, atol=1e-2
    )


def _plain(qs, anchors, blocks, nibbles):
    return adjacency_dot_plain(
        torch.from_numpy(qs), torch.from_numpy(anchors), torch.from_numpy(blocks),
        nibbles=nibbles,
    ).numpy()


@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("P", [4, 8])
def test_plain_matches_xla(P, nibbles):
    import jax.numpy as jnp
    from ggnn_tpu.ops.adjacency_pallas import adjacency_dot_xla

    qs, anchors, blocks = _inputs(7, 16, P, 24, 128, 300, nibbles)
    ref = np.asarray(adjacency_dot_xla(
        jnp.asarray(qs), jnp.asarray(anchors), jnp.asarray(blocks), nibbles=nibbles
    ))
    out = _plain(qs, anchors, blocks, nibbles)
    assert out.shape == ref.shape == (16, P, 48 if nibbles else 24)
    _assert_live_close(out, ref, anchors)


@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("P", [4, 8])
def test_plain_matches_pallas_interpret(P, nibbles):
    import jax.numpy as jnp
    from ggnn_tpu.ops.adjacency_pallas import adjacency_dot as pallas_adjacency_dot

    qs, anchors, blocks = _inputs(11, 16, P, 24, 128, 300, nibbles)
    ref = np.asarray(pallas_adjacency_dot(
        jnp.asarray(qs), jnp.asarray(anchors), jnp.asarray(blocks),
        nibbles=nibbles, interpret=True,
    ))
    out = _plain(qs, anchors, blocks, nibbles)
    _assert_live_close(out, ref, anchors)


@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("D", [256, 960, 4096])
def test_plain_matches_xla_wide_rows(D, nibbles):
    """Code rows of 256 to 4,096 bytes: the wide kernel's rows (D > 512)
    and the widest the reference allows, at the walks' 24 codes a block."""
    import jax.numpy as jnp
    from ggnn_tpu.ops.adjacency_pallas import adjacency_dot_xla

    qs, anchors, blocks = _inputs(D, 16, 8, 24, D, 300, nibbles)
    ref = np.asarray(adjacency_dot_xla(
        jnp.asarray(qs), jnp.asarray(anchors), jnp.asarray(blocks), nibbles=nibbles
    ))
    out = _plain(qs, anchors, blocks, nibbles)
    assert out.shape == ref.shape == (16, 8, 48 if nibbles else 24)
    _assert_live_close(out, ref, anchors)


@pytest.mark.parametrize("D,nibbles,want", [
    (16, False, ("u8", 1, False)), (48, False, ("u8", 4, False)),
    (128, False, ("u8", 8, False)), (512, True, ("int4", 32, False)),
    (528, False, ("u8", 32, True)), (960, False, ("u8", 32, True)),
    (4096, True, ("int4", 32, True)),
    (4, False, ("u8_tail", 1, False)), (20, False, ("u8_tail", 8, False)),
    (100, False, ("u8_tail", 32, False)), (100, True, ("int4_tail", 32, False)),
    (116, False, ("u8_tail", 32, False)), (132, False, ("u8_tail", 32, True)),
    (516, True, ("int4_tail", 32, True)), (772, False, ("u8_tail", 32, True))])
def test_variant_is_the_launchs_kernel(D, nibbles, want):
    """``variant`` names the kernel ``adjacency_dot_launch`` picks: lanes the
    power of two covering D/16 chunks, at most 32; wide above 32 chunks.
    Where D % 16 != 0 the tail kernels' chunks are D/4 4-byte words, and
    the layout says so; D % 16 == 0 keeps its 3-tuple (layout, lanes,
    wide) as the benchmark's readers unpack it."""
    assert adjacency.variant(D, nibbles) == want


@pytest.mark.parametrize("D", [1, 10, 98, 130])
def test_widths_off_4_bytes_have_no_kernel(D):
    """D % 4 != 0: the kernel route refuses it, naming the constraint; the
    plain route still answers."""
    qs, anchors, blocks = (torch.from_numpy(x) for x in _inputs(D, 4, 2, 8, D, 10, False))
    with pytest.raises(ValueError, match="D % 4 == 0"):
        adjacency._check_kernel_inputs(qs, anchors, blocks)
    assert adjacency_dot(qs, anchors, blocks).shape == (4, 2, 8)


@pytest.mark.parametrize("D, ok", [(100, True), (20, True), (128, False), (96, False)])
def test_tail_blocks_need_only_4_byte_alignment(D, ok):
    """Tail code rows start every D bytes, so the tail kernels read 4-byte
    words and accept blocks 4 bytes past an aligned start; the 16-byte
    kernels refuse them."""
    flat = torch.zeros(4 + 10 * 8 * D, dtype=torch.uint8)
    blocks = flat[4:].view(10, 8, D)
    qs = torch.zeros((4, D))
    anchors = torch.zeros((4, 2), dtype=torch.int32)
    if ok:
        adjacency._check_kernel_inputs(qs, anchors, blocks)
    else:
        with pytest.raises(ValueError, match="16-byte aligned blocks"):
            adjacency._check_kernel_inputs(qs, anchors, blocks)


def _kernel_order(qs, anchors, blocks, nibbles):
    """The plain version summed as the kernel sums, in f32: lane ``s`` of a
    code row's ``T`` lanes runs one fma chain over the bytes of its chunks
    ``s, s + T, ...`` (16 bytes a chunk, 4 in the tail kernels), in order;
    the lanes then add in a butterfly (offsets T/2, T/4, ..., 1). int4's
    high nibbles are summed in place, as 16x their value, and the sum scaled
    by 1/16. Every product is exact (a bf16 query times a code <= 255), so
    each addition rounds as the kernel's does."""
    B, D = qs.shape
    _, lanes, _ = adjacency.variant(D, nibbles)
    cb = 4 if D % 16 else 16
    nchunk = D // cb
    per_lane = -(-nchunk // lanes)
    q = qs.to(torch.bfloat16).to(torch.float32)
    q = torch.nn.functional.pad(q, (0, (per_lane * lanes - nchunk) * cb))
    q = q.view(B, per_lane, lanes, cb)
    craw = blocks[anchors.clamp_min(0).long()]  # [B, P, CR, D] u8
    parts = [craw & 15, craw & 0xF0] if nibbles else [craw]
    out = []
    for codes in parts:
        c = torch.nn.functional.pad(codes.to(torch.float32),
                                    (0, (per_lane * lanes - nchunk) * cb))
        c = c.view(*c.shape[:3], per_lane, lanes, cb)
        acc = torch.zeros(c.shape[:3] + (lanes,), dtype=torch.float32,
                          device=qs.device)
        for i in range(per_lane):
            for j in range(cb):
                acc = acc + q[:, None, None, i, :, j] * c[:, :, :, i, :, j]
        while acc.shape[-1] > 1:
            h = acc.shape[-1] // 2
            acc = acc[..., :h] + acc[..., h:]
        out.append(acc[..., 0])
    if nibbles:
        out[1] = out[1] * 0.0625
    return torch.cat(out, dim=2)


@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("D", [4, 20, 100, 132, 516])
def test_plain_matches_float64_einsum(D, nibbles):
    """Code rows of every tail width the card tests take, -1 anchors among
    them: the plain version (and the kernel's summation order) against the
    float64 sum of the bf16-rounded queries times the codes."""
    qs, anchors, blocks = _inputs(D + nibbles, 16, 8, 24, D, 300, nibbles)
    anchors[0] = -1
    q64 = torch.from_numpy(qs).to(torch.bfloat16).to(torch.float64).numpy()
    craw = blocks[np.clip(anchors, 0, None)].astype(np.int64)
    if nibbles:
        craw = np.concatenate([craw & 15, craw >> 4], axis=2)
    want = np.einsum("bd,bpkd->bpk", q64, craw.astype(np.float64))
    out = _plain(qs, anchors, blocks, nibbles)
    assert out.shape == want.shape == (16, 8, 48 if nibbles else 24)
    _assert_live_close(out, want, anchors)
    ordered = _kernel_order(*(torch.from_numpy(x) for x in (qs, anchors, blocks)),
                            nibbles).numpy()
    _assert_live_close(ordered, want, anchors)


def test_cpu_dispatch_takes_plain_route():
    qs, anchors, blocks = _inputs(3, 8, 4, 16, 64, 50, False)
    before = adjacency.launches
    by_variant = adjacency.variant_launches()
    out = adjacency_dot(
        torch.from_numpy(qs), torch.from_numpy(anchors), torch.from_numpy(blocks)
    )
    assert adjacency.launches == before  # the kernel was not launched
    assert adjacency.variant_launches() == by_variant
    np.testing.assert_array_equal(out.numpy(), _plain(qs, anchors, blocks, False))


@pytest.mark.parametrize(
    "qs_dtype, anchors_dtype, blocks_dtype",
    [
        (torch.float64, torch.int32, torch.uint8),
        (torch.float32, torch.int64, torch.uint8),
        (torch.float32, torch.int32, torch.int8),
    ],
)
def test_wrapper_rejects_wrong_dtypes(qs_dtype, anchors_dtype, blocks_dtype):
    qs = torch.zeros((4, 32), dtype=qs_dtype)
    anchors = torch.zeros((4, 2), dtype=anchors_dtype)
    blocks = torch.zeros((10, 8, 32), dtype=blocks_dtype)
    with pytest.raises(ValueError):
        adjacency_dot(qs, anchors, blocks)


def test_wrapper_rejects_shape_mismatch():
    with pytest.raises(ValueError):
        adjacency_dot(
            torch.zeros((4, 32)), torch.zeros((5, 2), dtype=torch.int32),
            torch.zeros((10, 8, 32), dtype=torch.uint8),
        )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nibbles", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, nibbles):
    qs, anchors, blocks = _inputs(5, 512, 8, 24 if nibbles else 48, 128, 4096,
                                  nibbles)
    args = [torch.from_numpy(x).to(cuda_device) for x in (qs, anchors, blocks)]
    before = adjacency.launches
    out = adjacency_dot(*args, nibbles=nibbles)
    torch.cuda.synchronize()
    assert adjacency.launches == before + 1
    ref = adjacency_dot_plain(*args, nibbles=nibbles)
    _assert_live_close(out.cpu().numpy(), ref.cpu().numpy(), anchors)


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm`` (selector nibbles 0-7, no sign mode): byte n
    of the result is byte ``(s >> 4n) & 7`` of the eight bytes [x | y]."""
    x = np.asarray(x, dtype=np.uint64)
    pool = x | (np.uint64(y) << np.uint64(32))
    out = np.zeros_like(x)
    for n in range(4):
        sel = np.uint64(((s >> (4 * n)) & 7) * 8)
        out |= ((pool >> sel) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


@pytest.mark.parametrize("mode", ["u8", "int4 low", "int4 high"])
def test_magic_conversion_is_exact(mode):
    """``__byte_perm(w, 0x4B000000, 0x7440 | k)`` as f32, minus 2^23, is
    byte k of w, for every byte value at every position; after the int4
    masks, the low nibble and 16x the high nibble (kept in place)."""
    rng = np.random.default_rng(0)
    b = np.arange(256, dtype=np.uint32)
    for k in range(4):
        noise = rng.integers(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
        w = (noise & ~np.uint32(0xFF << (8 * k))) | (b << np.uint32(8 * k))
        if mode == "int4 low":
            w, want = w & np.uint32(0x0F0F0F0F), b & 15
        elif mode == "int4 high":
            w, want = w & np.uint32(0xF0F0F0F0), (b >> 4) * 16
        else:
            want = b
        bits = _byte_perm(w, 0x4B000000, 0x7440 | k)
        assert np.all(bits == (np.uint32(0x4B000000) | want))
        val = bits.view(np.float32) - np.float32(8388608.0)
        assert val.dtype == np.float32
        np.testing.assert_array_equal(val, want.astype(np.float32))


def test_bf16_query_times_code_is_exact_in_f32():
    """A bf16-rounded query (8 significant bits) times a code 0..255 (8
    bits) has at most 16 significant bits: the f32 product is exact, so
    the kernel's fma of it equals the plain version's term for term."""
    rng = np.random.default_rng(1)
    q = (rng.normal(size=4096) * 2.0 ** rng.integers(-30, 30, size=4096)
         ).astype(np.float32)
    q = np.concatenate([q, (rng.random(4096) * 255.0).astype(np.float32)])
    qb = torch.from_numpy(q).to(torch.bfloat16).to(torch.float32).numpy()
    codes = np.arange(256, dtype=np.float32)
    prod32 = qb[:, None] * codes[None, :]
    prod64 = qb[:, None].astype(np.float64) * codes[None, :].astype(np.float64)
    np.testing.assert_array_equal(prod32.astype(np.float64), prod64)
    # the int4 high nibbles are summed as 16x their codes and scaled back by
    # 1/16: powers of two, so the f32 sum equals the unscaled one bit for bit
    rng2 = np.random.default_rng(2)
    idx = rng2.integers(0, 16, size=(512, 128))
    terms = qb[:128][None, :] * idx.astype(np.float32)
    acc = np.zeros(512, np.float32)
    acc16 = np.zeros(512, np.float32)
    for d in range(128):  # the kernel's sequential fma order
        acc = acc + terms[:, d]
        acc16 = acc16 + terms[:, d] * np.float32(16)
    np.testing.assert_array_equal(acc16 * np.float32(0.0625), acc)


def test_bound_counts_distinct_blocks_once():
    anchors = torch.tensor([[0, 0, -1], [1, -1, -1]], dtype=torch.int32)
    blocks = torch.zeros((3, 2, 16), dtype=torch.uint8)
    nbytes, flops, bound_ms, by = chip_smoke.bound(anchors, blocks, False)
    # 2 distinct blocks of 32 B, 2 query rows of 64 B, 6 anchors, 3 live
    # anchors x 2 outputs of 4 B
    assert nbytes == 2 * 32 + 2 * 64 + 6 * 4 + 3 * 2 * 4
    assert flops == 2 * 3 * 2 * 16
    assert by == "bytes" and bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert chip_smoke.bound(anchors, blocks, True)[0] == nbytes + 3 * 2 * 4


def test_launch_refuses_misaligned_qs():
    flat = torch.zeros(4 * 32 + 1)
    qs = flat[1:].view(4, 32)  # contiguous, 4 bytes past an aligned start
    anchors = torch.zeros((4, 2), dtype=torch.int32)
    blocks = torch.zeros((10, 8, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="aligned"):
        adjacency._check_kernel_inputs(qs, anchors, blocks)


RES_USAGE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function adjacency_dot_int4:
  REG:56 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:596 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function adjacency_dot_u8:
  REG:40 STACK:8 SHARED:16 LOCAL:24 CONSTANT[0]:596 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

SASS = """
\tcode for sm_90a
\t\tFunction : adjacency_dot_int4
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   PRMT R5, R4, 0x7440, R9 ;       /* 0x0000744004057816 */
        /*0020*/                   FADD R5, R5, -8388608 ;         /* 0x4b00000005057421 */
        /*0030*/                   EXIT ;                          /* 0x000000000000794d */
\t\tFunction : adjacency_dot_u8
        /*0000*/                   I2F.U32 R3, R2 ;                /* 0x0000000200037306 */
        /*0010*/              @!P0 I2FP.F32.U32 R4, R5 ;           /* 0x0000000500048245 */
        /*0020*/                   FFMA R6, R3, R4, R6 ;           /* 0x0000000403067223 */
"""


def test_cuobjdump_parsers():
    res = adjacency.parse_res_usage(RES_USAGE)
    assert res["adjacency_dot_int4"]["REG"] == 56
    assert res["adjacency_dot_u8"] == {
        "REG": 40, "STACK": 8, "SHARED": 16, "LOCAL": 24, "CONSTANT[0]": 596,
        "TEXTURE": 0, "SURFACE": 0, "SAMPLER": 0}
    assert adjacency.count_opcodes(SASS, "I2F") == {
        "adjacency_dot_int4": 0, "adjacency_dot_u8": 2}
    assert adjacency.count_opcodes(SASS, "PRMT") == {
        "adjacency_dot_int4": 1, "adjacency_dot_u8": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("D", [16, 32, 48, 96, 128, 256, 512, 1024])
@pytest.mark.parametrize("CR", [5, 13, 24, 48, 96])
def test_cuda_kernel_edges(cuda_device, CR, D, nibbles, P):
    """Ragged row batches (CR against rows per pass and rows in flight),
    every count of lanes per code row (D = 16 .. 512: 1 .. 32), the wide
    path (D > 512), a row of empty anchors and anchors >= N: the launch
    must not fault, live lanes must agree."""
    N = 40
    qs, _, blocks = _inputs(CR * 1000 + D + P, 33, P, CR, D, N, nibbles)
    rng = np.random.default_rng(D + CR)
    anchors = rng.integers(-1, N + 4, size=(33, P)).astype(np.int32)
    anchors[0] = -1
    anchors[1] = N + np.arange(P)
    args = [torch.from_numpy(x).to(cuda_device) for x in (qs, anchors, blocks)]
    before = adjacency.launches
    out = adjacency_dot(*args, nibbles=nibbles)
    torch.cuda.synchronize()
    assert adjacency.launches == before + 1
    live = (anchors >= 0) & (anchors < N)
    ref = adjacency_dot_plain(args[0], torch.from_numpy(np.where(live, anchors, -1))
                              .to(cuda_device), args[2], nibbles=nibbles)
    assert out.shape == ref.shape == (33, P, 2 * CR if nibbles else CR)
    _assert_live_close(out.cpu().numpy(), ref.cpu().numpy(),
                       np.where(live, anchors, -1))


# the fused walk's and the merges' launches at k_build 24, D = 960 (the
# gist1m cell): a query tile's step (1,024 rows, 8 pops) and its compacted
# phases, a merge chunk's step (8,192 rows) and a one-pop step
WIDE_SHAPES = [(1024, 8), (512, 8), (8192, 8), (1024, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("B,P", WIDE_SHAPES)
@pytest.mark.parametrize("D", [256, 960, 4096])
def test_cuda_kernel_at_wide_rows(cuda_device, D, B, P, nibbles):
    """Code rows of 256, 960 and 4,096 bytes (the wide kernel above 512) at
    the walks' shapes, 24 codes a block (12 rows of int4 pairs), about a
    tenth of the anchors -1: live lanes agree with the plain version, and
    the launch counts under its variant. Rows are cut where the plain
    version's gathered codes would pass 2 GiB (D = 4,096)."""
    CR = 12 if nibbles else 24
    B = min(B, (2 << 30) // (P * CR * D))
    N = 4096
    gen = torch.Generator(device=cuda_device).manual_seed(D + B + P)
    qs = torch.randn((B, D), generator=gen, device=cuda_device)
    anchors = torch.randint(0, N, (B, P), generator=gen, device=cuda_device,
                            dtype=torch.int32)
    anchors[torch.rand((B, P), generator=gen, device=cuda_device) < 0.1] = -1
    blocks = torch.randint(0, 256, (N, CR, D), generator=gen, device=cuda_device,
                           dtype=torch.uint8)
    key = adjacency.variant(D, nibbles)
    before = adjacency.variant_launches().get(key, 0)
    out = adjacency_dot(qs, anchors, blocks, nibbles=nibbles)
    torch.cuda.synchronize()
    assert adjacency.variant_launches()[key] == before + 1
    assert key[2] == (D > 512)
    ref = adjacency_dot_plain(qs, anchors, blocks, nibbles=nibbles)
    _assert_live_close(out.cpu().numpy(), ref.cpu().numpy(),
                       anchors.cpu().numpy())


def _integer_queries(B, D, device, seed):
    """Query rows of small integers: every product and partial sum of a
    dot with codes <= 255 is an integer below 2^24, so exact in f32 in any
    order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-8, 9, (B, D), generator=gen, device=device).to(torch.float32)


TAIL_WIDTHS = [4, 20, 100, 116, 516, 772]


@pytest.mark.cuda
@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("CR", [24, 48])
@pytest.mark.parametrize("D", TAIL_WIDTHS)
def test_cuda_tail_kernel_bit_equal_to_plain(cuda_device, D, CR, nibbles):
    """The tail kernels (D % 16 != 0) at every lane count and the wide loop:
    with exact sums the live lanes equal the plain version bit for bit; a
    row of empty anchors and anchors >= N fault nothing; the launch counts
    under the tail variant."""
    N, B, P = 64, 65, 8
    blocks = _inputs(D * 100 + CR, B, P, CR, D, N, nibbles)[2]
    anchors = np.random.default_rng(D + CR).integers(-1, N + 4, size=(B, P)).astype(np.int32)
    anchors[0] = -1
    anchors[1] = N + np.arange(P)
    live = (anchors >= 0) & (anchors < N)
    qs = _integer_queries(B, D, cuda_device, D + CR)
    a = torch.from_numpy(anchors).to(cuda_device)
    blk = torch.from_numpy(blocks).to(cuda_device)
    key = adjacency.variant(D, nibbles)
    assert key[0].endswith("_tail")
    before = adjacency.variant_launches().get(key, 0)
    out = adjacency_dot(qs, a, blk, nibbles=nibbles)
    torch.cuda.synchronize()
    assert adjacency.variant_launches()[key] == before + 1
    ref = adjacency_dot_plain(qs, torch.from_numpy(np.where(live, anchors, -1))
                              .to(cuda_device), blk, nibbles=nibbles)
    m = torch.from_numpy(live).to(cuda_device)
    assert torch.equal(out[m], ref[m])


@pytest.mark.cuda
@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("D", [96, 128, 960, 100, 516])
def test_cuda_kernel_bit_equal_in_its_summation_order(cuda_device, D, nibbles):
    """Normal queries, where the order of the additions shows: the 16-byte
    instances (deep1m's 96, sift1m's 128, gist1m's 960) and the tail ones
    (100, 516) equal :func:`_kernel_order` bit for bit on live lanes."""
    N, B, P = 256, 96, 8
    CR = 12 if nibbles else 24
    qs, anchors, blocks = _inputs(D + 7 * nibbles, B, P, CR, D, N, nibbles)
    args = [torch.from_numpy(x).to(cuda_device) for x in (qs, anchors, blocks)]
    out = adjacency_dot(*args, nibbles=nibbles)
    torch.cuda.synchronize()
    want = _kernel_order(*args, nibbles)
    m = args[1] >= 0
    assert torch.equal(out[m], want[m])
