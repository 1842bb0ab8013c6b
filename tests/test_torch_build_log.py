"""The build phase's reading of ptxas's report in ``chip_smoke.py``: the
``warpgroup.arrive``s that ptxas injected between wgmma's (C7519), its
other notes on wgmma pipelines (serialised products, injected waits)
and the spill bytes, counted per entry function; the nine sm90 flash
instantiations (B1-B3 at head dims 64, 128 and 256) refused when any of
them carries one, spills or is missing, and B5's fifteen (its
tensor-core and FMA kernels) when any spills or is missing."""

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
