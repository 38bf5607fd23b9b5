"""The build reports ``chip_smoke.py`` and ``tools/flash_fwd_check.py``
read on the card, parsed on the CPU: the forward kernels' ``ptxas``
records by the labels ``flash_attention.FORWARD_NO_SPILL`` names, and the
``HGMMA`` / ``HMMA`` counts of each kernel's SASS (``ops.sass_counts``).
The mangled names are an H100 build's (nvcc 12.9, sm_90a)."""
import subprocess
from types import SimpleNamespace

from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops

NS = "_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c138979"
ARGS = "EEEv14CUtensorMap_stS1_S1_NS_7FwdBf16E"
BF16 = {"flash_fwd_bf16<64,64,128,3>": "ILi64ELi64ELi128ELi3",
        "flash_fwd_bf16<128,128,64,3>": "ILi128ELi128ELi64ELi3",
        "flash_fwd_bf16<192,128,64,3>": "ILi192ELi128ELi64ELi3",
        "flash_fwd_bf16<256,256,64,2>": "ILi256ELi256ELi64ELi2"}
FP32 = NS + "22flash_attention_kernelILi8EEEvPKfS2_S2_Pfiiiiiiiiiifi"


def _mangled(label):
    return NS + "14flash_fwd_bf16" + BF16[label] + ARGS


def test_forward_no_spill_labels_are_the_kernels():
    assert set(flash_mod.FORWARD_NO_SPILL) < set(BF16)
    lines = []
    for label in BF16:
        lines += [f"ptxas info    : Compiling entry function "
                  f"'{_mangled(label)}' for 'sm_90a'",
                  "ptxas info    : Function properties for "
                  f"{_mangled(label)}",
                  "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                  "spill loads",
                  "ptxas info    : Used 168 registers, used 2 barriers"]
    recs = ops.ptxas_kernels("\n".join(lines))
    assert [r["kernel"] for r in recs] == list(BF16)
    assert all(r["registers"] == 168 and r["spill_stores"] == 0
               for r in recs)
    assert ops._kernel_label(FP32) == "flash_attention_kernel<8>"


def test_sass_counts_reads_each_kernels_mma_instructions(monkeypatch):
    listing = "\n".join([
        "\tcode for sm_90a",
        f"\t\tFunction : {_mangled('flash_fwd_bf16<128,128,64,3>')}",
        "        /*0200*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, "
        "!UPT, gsb0 ;",
        "        /*0210*/  HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR8], "
        "R88, gsb0 ;",
        "        /*0220*/  FMUL R3, R3, R4 ;",
        f"\t\tFunction : {FP32}",
        "        /*0100*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "        /*0110*/  HMMA.1688.F32.TF32 R4, R8, R14, R4 ;"])
    monkeypatch.setattr(ops, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: SimpleNamespace(
        stdout=listing))
    assert ops.sass_counts("flash_attention") == {
        "flash_fwd_bf16<128,128,64,3>": {"HGMMA": 2, "HMMA": 0},
        "flash_attention_kernel<8>": {"HGMMA": 0, "HMMA": 2}}
