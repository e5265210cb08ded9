"""The probes' kernel layouts on the CPU: what the wrappers mirror of S4's
band-and-cluster geometry and shared memory, the library yardstick of the
launch-floor family, the SASS loop counter and ``ab_parent``'s S4 and S3
input sets.  Torch only (no JAX), small tensors, one torch thread."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gymca_torch.probes import ab_parent
from gymca_torch.probes import ca_variants_kernel as cv
from gymca_torch.probes import floor_kernel as fk
from gymca_torch.probes import sass
from gymca_torch.probes.exp_ca_variants import make_inputs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("h", [1, 3, 40, 250, 256, 512])
def test_bands_own_every_row_once_and_stage_inside_the_grid(h):
    bands = cv.bands(h)
    assert len(bands) == cv.CLUSTER_BLOCKS
    owned = np.zeros(h, int)
    band = -(-h // cv.CLUSTER_BLOCKS)
    for r0, r1, rs, re in bands:
        assert 0 <= r0 <= r1 <= h and r1 - r0 <= band
        owned[r0:r1] += 1
        assert 0 <= rs <= re <= h
        if r0 < r1:  # a halo row each side, inside the grid
            assert rs == max(r0 - 1, 0) and re == min(r1 + 1, h)
            assert re - rs <= band + 2
    assert (owned == 1).all()


@pytest.mark.parametrize("variant", cv.VARIANTS)
@pytest.mark.parametrize("n,h,w", [(2, 40, 32), (3, 3, 16), (1, 1, 8), (2, 250, 12)])
def test_band_partition_equals_the_plain_version(variant, n, h, w):
    """Each block's staged rows stepped alone, its owned rows kept and its
    counts summed, as the kernel does, give the whole grid's step."""
    grid, weights = make_inputs(n, h, w, n * h + w, "cpu")
    want_grid, want_counts = cv.PLAIN[variant](grid.clone(), weights)
    got = torch.empty_like(grid)
    counts = torch.zeros((n, 2), dtype=torch.int32)
    for r0, r1, rs, re in cv.bands(h):
        if r0 == r1:
            continue
        staged, _ = cv.PLAIN[variant](grid[:, rs:re].clone(), weights)
        mine = staged[:, r0 - rs:r1 - rs]
        got[:, r0:r1] = mine
        counts += torch.stack([(mine == cv.TREE).sum(dim=(1, 2)),
                               (mine == cv.FIRE).sum(dim=(1, 2))], dim=-1).to(torch.int32)
    assert torch.equal(got, want_grid)
    assert torch.equal(counts, want_counts)


def test_shared_memory_follows_the_band():
    # two stages of ceil(h / 4) + 2 rows, padded to whole words
    assert cv.shared_memory_bytes(256, 256) == 2 * 66 * 256
    assert cv.shared_memory_bytes(250, 50) == 2 * (63 + 2) * 52
    assert cv.shared_memory_bytes(1, 64) == 2 * 3 * 64
    assert cv.shared_memory_bytes(512, 512) == 2 * 130 * 512
    limit = cv._MAX_SHARED_BYTES
    assert cv.shared_memory_bytes(512, 512) <= limit < cv.shared_memory_bytes(1024, 1024)
    assert limit < 232448  # a block's opt-in maximum, less the static part


def test_the_cpu_wrapper_takes_grids_past_the_cards_limit():
    grid, weights = make_inputs(1, 1024, 1024, 0, "cpu")
    assert cv.shared_memory_bytes(1024, 1024) > cv._MAX_SHARED_BYTES  # refused on the card
    b, cb = cv.reference_step(grid.clone(), weights)
    for variant in cv.VARIANTS:
        a, ca = cv.ca_variant_step(variant, grid.clone(), weights)
        assert torch.equal(a, b) and torch.equal(ca, cb), variant


def test_one_sm_copy_on_the_cpu_is_a_copy_and_refuses_what_the_kernel_cannot_take():
    src = torch.arange(64, dtype=torch.int8)
    dst = torch.zeros_like(src)
    assert fk.one_sm_copy(src, dst) is dst and torch.equal(dst, src)
    for bad_src, bad_dst in ((src[:40], dst[:40]),  # not a multiple of 16 bytes
                             (src.view(4, 16), dst.view(4, 16)),  # not 1-D
                             (src[:48], dst[:32])):  # lengths differ
        with pytest.raises(ValueError):
            fk.one_sm_copy(bad_src, bad_dst)


@pytest.mark.parametrize("table_w", [8, 16])
@pytest.mark.parametrize("counts_w", [1, 4])
def test_pad_of_the_table_is_the_floor_familys_function(table_w, counts_w):
    """``F.pad(table[:, 4:6], (0, 2))``, cut to ``counts_w``, is what the
    kernel writes where the table is 8 or 16 wide; with the padding
    ``counts_w - 2`` one call gives it at its width."""
    gen = torch.Generator().manual_seed(table_w + counts_w)
    table = torch.randint(-2**31, 2**31 - 1, (37, table_w), generator=gen, dtype=torch.int32)
    want = fk.probe_floor_plain(37, table, counts_w=counts_w)
    assert torch.equal(F.pad(table[:, 4:6], (0, 2))[:, :counts_w], want)
    assert torch.equal(F.pad(table[:, 4:6], (0, counts_w - 2)), want)


def test_floor_tables_are_the_ones_the_sweep_draws():
    variants = [fk.FloorVariant("a", 5, 2, 8, 4), fk.FloorVariant("b", 3, 3, 0, 1),
                fk.FloorVariant("c", 4, 4, 16, 4)]
    tables = fk.variant_tables(variants, "cpu")
    assert tables[1] is None and tables[0].shape == (5, 8) and tables[2].shape == (4, 16)
    again = fk.variant_tables(variants, "cpu")
    assert torch.equal(tables[0], again[0]) and torch.equal(tables[2], again[2])


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_114ca_swar_kernelILb1EEEvPaPKiPiiiiib
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
                                                                         /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                    /* 0x0000000000007919 */
.L_x_1:
        /*0020*/                   LDS.128 R4, [R2] ;                    /* 0x0000000002047984 */
.L_x_2:
        /*0030*/                   LOP3.LUT R5, R4, 0x19191919, RZ, 0x3c, !PT ;
        /*0040*/                   STG.E.128 desc[UR4][R8.64], R4 ;
        /*0050*/                   IADD3 R2, R2, 0x80, RZ ;
        /*0060*/               @P0 BRA `(.L_x_2) ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/              @!P1 BRA 0x20 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0 ;
		Function : _ZN12_GLOBAL__N_114ca_swar_kernelILb0EEEvPaPKiPiiiiib
        /*0000*/                   STG.E desc[UR4][R8.64], R4 ;
        /*0010*/                   EXIT ;
"""


def test_inner_loop_counts_the_innermost_loop_around_the_marker():
    fns = sass.functions(SASS)
    assert sorted(fns) == ["_ZN12_GLOBAL__N_114ca_swar_kernelILb0EEEvPaPKiPiiiiib",
                           "_ZN12_GLOBAL__N_114ca_swar_kernelILb1EEEvPaPKiPiiiiib"]
    bulk = fns["_ZN12_GLOBAL__N_114ca_swar_kernelILb1EEEvPaPKiPiiiiib"]
    assert len(bulk) == 11 and bulk[6] == (0x60, "@P0 BRA 0x30")
    loop = sass.inner_loop(bulk, "STG.E.128")
    assert loop == sass.Loop(0x30, 0x60, 4, 1, {"LOP3": 1, "STG": 1, "IADD3": 1, "BRA": 1})
    outer = sass.inner_loop(bulk, "BAR.SYNC")
    assert outer[:4] == (0x20, 0x80, 7, 1) and outer.opcodes["BRA"] == 2
    assert sass.inner_loop(fns["_ZN12_GLOBAL__N_114ca_swar_kernelILb0EEEvPaPKiPiiiiib"],
                           "STG") is None


def test_clocks_per_item_counts_each_pipe_at_its_rate():
    loop = sass.Loop(0, 0x90, 10, 2, {"LOP3": 4, "IMAD": 2, "FFMA": 2, "POPC": 1, "LDS": 1})
    got = sass.clocks_per_item(loop, items=2)
    # issue 10 / 128; ALU 4 / 64; FMA max(2 / 64, 4 / 128); XU 1 / 16; per item
    assert got == {"issue": 10 / 128 / 2, "alu": 4 / 64 / 2, "fma": 2 / 64 / 2,
                   "xu": 1 / 16 / 2}
    floats = sass.Loop(0, 0x90, 10, 1, {"FFMA": 8, "IMAD": 1})
    assert sass.clocks_per_item(floats, 1)["fma"] == 9 / 128


def test_ab_parent_builds_and_names_the_s4_and_s3_sets():
    gen = torch.Generator().manual_seed(0)
    s4 = ab_parent.s4_sets(gen, device="cpu", sizes=((3, 2), (5, 1)), size=16)
    assert sorted(s4) == sorted(f"S4 {v} {n} x 16²" for v in cv.VARIANTS for n in (3, 5))
    s3 = ab_parent.s3_sets(gen, device="cpu", size=2)
    assert list(s3) == ["S3 B=32", "S3 B=128", "S3 B=512", "S3 B=4096"]
    assert [t.shape[1] for _, t, _ in s3.values()] == [16, 16, 8, 8]
    for name, data in {**s4, **s3}.items():
        step = ab_parent.THIS_TREE[name[:2]]
        run, reset, calls, err = ab_parent._case(name, data, step, repeats=2)
        assert err() == 0, name
        before = data[1].clone()
        run()
        if reset is not None:
            reset()
        assert torch.equal(data[1], before), name  # the set's inputs are left as they were
    assert ab_parent.S4_SIZES == ((256, 40), (4096, 4))
    assert ab_parent.KERNEL_NAMES["S3"] == "probe_floor_kernel"
