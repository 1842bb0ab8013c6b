"""The build phase's reading of ptxas's report in ``chip_smoke.py``: the
``warpgroup.arrive``s that ptxas injected between wgmma's (C7519), its
other notes on wgmma pipelines (serialised products, injected waits)
and the spill bytes, counted per entry function; the nine sm90 flash
instantiations (B1-B3 at head dims 64, 128 and 256) refused when any of
them carries one, spills or is missing, and B5's fifteen (its
tensor-core and FMA kernels) when any spills or is missing; and B1's
loop read from its SASS (``sass_order``): whether its softmax's
exponentials come before the wait for its own P V, and a refusal when
an instantiation is missing or its walk is not pipelined."""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


def _mangled(kernel: str, hd: int) -> str:
    return (f"_ZN51_GLOBAL__N__554ebcc5_18_flash_attention_cu_bc6dc9734sm90"
            f"{len(kernel)}{kernel}ILi{hd}EEEv14CUtensorMap_stS2_S2_NS_4ArgsE")


FWD_128 = _mangled("flash_fwd_kernel_sm90", 128)
DQ_64 = _mangled("flash_bwd_dq_kernel_sm90", 64)
FWD_256 = _mangled("flash_fwd_kernel_sm90", 256)


def _entry(name: str, spill=(0, 0), arrives=0, named=True,
           serialised=False) -> list:
    """ptxas -v's lines for one entry function, as nvcc prints them."""
    lines = [f"ptxas info    : Compiling entry function '{name}' for "
             f"'sm_90a'"]
    for i in range(arrives):
        where = f" in function '{name}'" if named else ""
        lines.append(f"ptxas info    : (C7519) warpgroup.arrive is injected "
                     f"in around line {1000 + i} by compiler to allow use "
                     f"of registers in GMMA{where}")
    if serialised:
        lines.append("ptxas info    : (C7515) Potential Performance Loss: "
                     "wgmma.mma_async instructions are serialized due to "
                     "non wgmma instructions defining accumulator registers "
                     "of a wgmma between start and end of the pipeline "
                     f"stage in the function '{name}'")
    lines += [f"ptxas info    : Function properties for {name}",
              f"    0 bytes stack frame, {spill[0]} bytes spill stores, "
              f"{spill[1]} bytes spill loads",
              "ptxas info    : Used 168 registers, used 1 barriers, 720 "
              "bytes cmem[0]"]
    return lines


# three entry functions: B1 at 128 clean, B2 at 64 with two injected
# arrives, B1 at 256 spilling
LOG = "\n".join(["ptxas info    : 0 bytes gmem"] + _entry(FWD_128)
                + _entry(DQ_64, arrives=2) + _entry(FWD_256, spill=(8, 12)))


def test_injected_arrives_are_counted_per_entry_function():
    assert cs._wgmma_notes(LOG) == {FWD_128: {}, DQ_64: {"C7519": 2},
                                    FWD_256: {}}


def test_spills_are_read_per_entry_function():
    assert cs._spills(LOG) == {FWD_128: (0, 0), DQ_64: (0, 0),
                               FWD_256: (8, 12)}


def test_other_wgmma_notes_are_counted_by_code():
    log = "\n".join(_entry(FWD_128, serialised=True)
                    + _entry(DQ_64, arrives=2))
    assert cs._wgmma_notes(log) == {FWD_128: {"C7515": 1},
                                    DQ_64: {"C7519": 2}}


def test_a_note_without_a_name_belongs_to_the_entry_being_compiled():
    log = "\n".join(_entry(FWD_128) + _entry(DQ_64, arrives=3, named=False))
    assert cs._wgmma_notes(log) == {FWD_128: {}, DQ_64: {"C7519": 3}}


def test_kernel_names_are_read_from_the_mangled_names():
    found = cs.SM90_FLASH_KERNEL.search(DQ_64)
    assert found.groups() == ("flash_bwd_dq_kernel_sm90", "64")
    assert cs.SM90_FLASH_KERNEL.search(FWD_256).groups() == (
        "flash_fwd_kernel_sm90", "256")


KERNELS = ("flash_fwd_kernel_sm90", "flash_bwd_dq_kernel_sm90",
           "flash_bwd_dkv_kernel_sm90")


def _flash_log(faulty=("flash_fwd_kernel_sm90", 128), arrives=0,
               spill=(0, 0), serialised=False, left_out=None) -> str:
    """The nine sm90 flash instantiations, the ``faulty`` one (kernel,
    head dim) with ``arrives``, ``spill`` and a serialised pipeline if
    asked, and the ``left_out`` one missing."""
    lines = []
    for kernel in KERNELS:
        for hd in (64, 128, 256):
            if (kernel, hd) == left_out:
                continue
            name = _mangled(kernel, hd)
            lines += (_entry(name, spill, arrives, serialised=serialised)
                      if (kernel, hd) == faulty else _entry(name))
    return "\n".join(lines)


def _b1_log(arrives=0, spill=(0, 0), serialised=False,
            hds=(64, 128, 256)) -> str:
    """The nine instantiations, B1 at 128 with ``arrives``, ``spill``
    and a serialised pipeline if asked, and B1 only at ``hds``."""
    missing = [hd for hd in (64, 128, 256) if hd not in hds]
    return _flash_log(arrives=arrives, spill=spill, serialised=serialised,
                      left_out=("flash_fwd_kernel_sm90", missing[0])
                      if missing else None)


def _check(log, refused, capsys) -> str:
    if refused:
        with pytest.raises(AssertionError):
            cs._check_flash_build(log)
    else:
        cs._check_flash_build(log)
    return capsys.readouterr().out


@pytest.mark.parametrize("log, refused", [
    (_b1_log(), False),
    (_b1_log(arrives=1), True),
    (_b1_log(spill=(4, 4)), True),
    (_b1_log(serialised=True), True),
    (_b1_log(hds=(64, 128)), True),
], ids=["clean", "injected_arrive", "spill", "serialised",
        "instantiation_missing"])
def test_the_build_check_refuses_a_serialised_or_spilling_b1(log, refused,
                                                             capsys):
    printed = _check(log, refused, capsys)
    assert "flash_bwd_dq_kernel_sm90<64>: 0 injected warpgroup.arrive" \
        in printed


@pytest.mark.parametrize("log, refused", [
    (_flash_log(faulty=None), False),
    (_flash_log(("flash_bwd_dq_kernel_sm90", 64), arrives=2), True),
    (_flash_log(("flash_bwd_dq_kernel_sm90", 256), arrives=1), True),
    (_flash_log(("flash_bwd_dkv_kernel_sm90", 256), spill=(8, 8)), True),
    (_flash_log(("flash_bwd_dkv_kernel_sm90", 128), serialised=True), True),
    (_flash_log(faulty=None, left_out=("flash_bwd_dkv_kernel_sm90", 64)),
     True),
], ids=["clean_nine", "b2_injected_arrives", "b2_256_injected_arrive",
        "b3_256_spill", "b3_serialised", "b3_missing"])
def test_the_build_check_refuses_a_serialised_or_spilling_b2_or_b3(
        log, refused, capsys):
    printed = _check(log, refused, capsys)
    # every instantiation built is printed with its notes and spills
    assert printed.count("spill bytes (stores, loads)") == \
        log.count("Compiling entry function")


def _decode_mangled(kind: str, args: str) -> str:
    kernel = f"flash_decode_{kind}_kernel"
    return (f"_ZN52_GLOBAL__N__e034a0ba_19_decode_attention_cu_de523dbf"
            f"{len(kernel)}{kernel}I{args}EEvNS_4ArgsE")


# B5's fifteen instantiations: the tensor-core kernel over bf16 and int8
# caches at head dims 64, 128 and 256, and the FMA kernel's layouts
DECODE_ENTRIES = (
    [("mma", f"{tc}Li{hd}E") for tc in ("13__nv_bfloat16", "a")
     for hd in (64, 128, 256)]
    + [("fma", f"ff{lps}Li{ppl}E") for lps, ppl in
       (("Li32E", 2), ("Li32E", 1), ("Li16E", 1), ("Li8E", 1), ("Li4E", 1))]
    + [("fma", f"fa{lps}Li1E") for lps in
       ("Li16E", "Li8E", "Li4E", "Li2E")])


def _decode_log(spill_at=None, left_out=None) -> str:
    """B5's instantiations, the ``spill_at``-th spilling, the
    ``left_out``-th missing."""
    lines = []
    for i, (kind, args) in enumerate(DECODE_ENTRIES):
        if i != left_out:
            lines += _entry(_decode_mangled(kind, args),
                            (12, 24) if i == spill_at else (0, 0))
    return "\n".join(lines)


@pytest.mark.parametrize("log, refused", [
    (_decode_log(), False),
    (_decode_log(spill_at=1), True),
    (_decode_log(spill_at=10), True),
    (_decode_log(left_out=14), True),
], ids=["clean_fifteen", "mma_128_spill", "fma_spill", "fma_missing"])
def test_the_build_check_refuses_a_spilling_b5_instantiation(log, refused,
                                                              capsys):
    if refused:
        with pytest.raises(AssertionError):
            cs._check_decode_build(log)
    else:
        cs._check_decode_build(log)
    printed = capsys.readouterr().out
    assert "flash_decode_mma_kernel instantiations 6" in printed
    assert "flash_decode_fma_kernel instantiations" in printed


# one SASS line per mark of ``chip_smoke.sass_order``; E is a run of 8
# exponentials, shorter runs (the rescale's) are not marked
SASS_LINES = {
    "H": ["HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;"],
    "W0": ["WARPGROUP.DEPBAR.LE gsb0, 0x0 ;"],
    "W1": ["WARPGROUP.DEPBAR.LE gsb0, 0x1 ;"],
    "S": ["BAR.SYNC.DEFER_BLOCKING R2, 0x100 ;"],
    "A": ["BAR.ARV R3, 0x100 ;"],
    "E": ["MUFU.EX2 R40, R41 ;"] * 8,
    "e": ["MUFU.EX2 R40, R41 ;"] * 2,
    "F": ["FMNMX R5, R6, R7, !PT ;", "FFMA R8, R9, R10, R11 ;"],
}


def _listing(kernel: str, hd: int, marks: str) -> str:
    """A function of a ``cuobjdump -sass`` listing whose instructions
    read, by sass_order, as ``marks``."""
    lines = [f"\n\t\tFunction : {_mangled(kernel, hd)}",
             "\t.headerflags\t@\"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\""]
    pc = 0
    for mark in marks.split():
        for text in SASS_LINES[mark]:
            lines.append(f"        /*{pc:04x}*/                   {text}"
                         f"  /* 0x000fe20000000f00 */")
            pc += 16
    return "\n".join(lines)


# B1's loops: the parent's (the wait for P V above the exponentials) and
# one whose softmax runs under its own P V; both peel the first tile,
# whose softmax follows a wait to none with nothing else in flight
PARENT_LOOP = "S H A W0 e F E F S H H A W1 W0 e F E F H W0"
UNDER_PV_LOOP = "S H A W0 e F E F S S H H A W1 e F E F W0 S H W0"


def _sass_of(b1: dict) -> str:
    """A listing of B1 at the head dims in ``b1`` (hd -> marks) beside
    B2 and B3 at every head dim."""
    parts = [_listing("flash_fwd_kernel_sm90", hd, marks)
             for hd, marks in b1.items()]
    parts += [_listing(kernel, hd, "S H H W0 F H W0")
              for kernel in KERNELS[1:] for hd in (64, 128, 256)]
    return "Fatbin elf code:\n" + "\n".join(parts)


def test_the_sass_order_reads_products_waits_barriers_and_exponentials():
    listing = _listing("flash_fwd_kernel_sm90", 128, UNDER_PV_LOOP)
    assert cs.sass_order(listing) == \
        "S H A W0 E S S H A W1 E W0 S H W0"
    [(name, part)] = list(cs._sass_functions("x\n" + listing))
    assert name == _mangled("flash_fwd_kernel_sm90", 128)


@pytest.mark.parametrize("order, under", [
    (cs.sass_order(_listing("flash_fwd_kernel_sm90", 128, PARENT_LOOP)),
     False),
    (cs.sass_order(_listing("flash_fwd_kernel_sm90", 128, UNDER_PV_LOOP)),
     True),
    ("S H A W1 E W0 E S H A W1 W0 E H W0", False),
    ("S H A W1 E W0 E S H A W1 E W0 E H W0", True),
    ("S H A W0 E H W0", False),
], ids=["parent", "softmax_under_pv", "one_loop_waits_first",
        "every_loop_under_pv", "no_pipelined_wait"])
def test_the_softmax_under_pv_needs_exponentials_before_each_wait(order,
                                                                  under):
    assert cs._softmax_under_pv(order) is under


@pytest.mark.parametrize("b1, refused, under", [
    ({64: PARENT_LOOP, 128: PARENT_LOOP, 256: PARENT_LOOP}, False, False),
    ({64: UNDER_PV_LOOP, 128: UNDER_PV_LOOP, 256: UNDER_PV_LOOP}, False,
     True),
    ({64: PARENT_LOOP, 128: PARENT_LOOP}, True, None),
    ({64: PARENT_LOOP, 128: "S H A W0 e F E F H W0", 256: PARENT_LOOP},
     True, None),
], ids=["parent", "softmax_under_pv", "b1_256_missing",
        "no_pipelined_wait"])
def test_the_order_check_prints_b1s_loop_and_refuses_an_unpipelined_one(
        b1, refused, under, capsys):
    sass = _sass_of(b1)
    if refused:
        with pytest.raises(AssertionError):
            cs._check_b1_order(sass)
    else:
        assert cs._check_b1_order(sass) == {64: under, 128: under,
                                            256: under}
    printed = capsys.readouterr().out
    for hd in (64, 128, 256):
        assert f"flash_fwd_kernel_sm90<{hd}> in order: " in printed
    assert cs.sass_order(_listing("flash_fwd_kernel_sm90", 128,
                                  b1[128])) in printed
