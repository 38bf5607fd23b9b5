"""The build reports ``chip_smoke.py``, ``tools/flash_fwd_check.py`` and
``tools/flash_bwd_check.py`` read on the card, parsed on the CPU: the
forward's bf16 and the backward's fp32 and bf16 kernels' ``ptxas``
records by the labels ``flash_attention.FORWARD_NO_SPILL`` and
``BACKWARD.NO_SPILL`` name, and the ``HGMMA`` / ``HMMA`` counts of each
kernel's SASS (``ops.sass_counts``). The mangled names are an H100
build's (nvcc 12.9, sm_90a)."""
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
# the backward's: rows kernels take 4 tensor maps, keys kernels 5
BWD_NS = "_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_2b1a21a5"
BWD_BF16 = ("flash_bwd_rows_bf16<64,64,64,3>", "flash_bwd_rows_bf16<128,128,64,3>",
            "flash_bwd_rows_bf16<192,128,64,3>", "flash_bwd_rows_bf16<256,256,32,2>",
            "flash_bwd_keys_bf16<64,64,64,4,1>", "flash_bwd_keys_bf16<128,128,32,4,1>",
            "flash_bwd_keys_bf16<192,128,16,4,1>", "flash_bwd_keys_bf16<256,256,32,3,2>")
BWD_FP32 = ("flash_bwd_rows_f32<64,64,32,4,1,1>", "flash_bwd_rows_f32<128,128,32,2,0,1>",
            "flash_bwd_rows_f32<192,128,16,2,0,1>", "flash_bwd_rows_f32<256,256,16,1,0,0>",
            "flash_bwd_keys_f32<64,64,32,2,1,1,1>", "flash_bwd_keys_f32<128,128,32,2,1,0,0>",
            "flash_bwd_keys_f32<192,128,16,2,1,0,0>",
            "flash_bwd_keys_f32<256,256,16,1,2,0,0>")


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


def _bwd_mangled(label):
    name, args = label[:-1].split("<")
    maps = 4 if name.startswith("flash_bwd_rows") else 5
    arg = "NS_6BwdF32E" if name.endswith("f32") else "NS_7BwdBf16E"
    return (BWD_NS + f"{len(name)}{name}I"
            + "".join(f"Li{n}E" for n in args.split(",")) + "EEEv14CUtensorMap_st"
            + "S1_" * (maps - 1) + arg)


def test_backward_no_spill_labels_are_the_kernels():
    """Every label of ``BACKWARD.NO_SPILL`` is one of the backward's fp32
    or bf16 kernels, each read back from its mangled name with its spills;
    the fp32 ones are there (rows and keys)."""
    kernels = BWD_BF16 + BWD_FP32
    assert set(flash_mod.BACKWARD.NO_SPILL) <= set(kernels)
    assert {k.split("<")[0] for k in flash_mod.BACKWARD.NO_SPILL} >= {
        "flash_bwd_rows_f32", "flash_bwd_keys_f32"}
    lines = []
    for i, label in enumerate(kernels):
        spill = 16 if i % 3 == 2 else 0
        lines += [f"ptxas info    : Compiling entry function "
                  f"'{_bwd_mangled(label)}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {_bwd_mangled(label)}",
                  f"    {spill} bytes stack frame, {spill} bytes spill stores, "
                  f"{spill} bytes spill loads",
                  "ptxas info    : Used 168 registers, used 3 barriers"]
    recs = ops.ptxas_kernels("\n".join(lines))
    assert [r["kernel"] for r in recs] == list(kernels)
    assert [r["spill_stores"] for r in recs] == [
        16 if i % 3 == 2 else 0 for i in range(len(kernels))]


def test_one_query_no_spill_labels_are_the_kernels():
    """The one-query route's instantiations (outputs a thread a pass), by
    the mangled names of a build of ``flash_fwd_one_query<EPT>(OneQuery<
    float>)`` and ``flash_fwd_one_query_bf16<EPT>(OneQuery<bf16>)``
    beside the tile kernels', one of them spilling."""
    mangled = [NS + f"19flash_fwd_one_queryILi{n}EEEvNS_8OneQueryIfEE"
               for n in (1, 2, 4)]
    mangled += [NS + f"24flash_fwd_one_query_bf16ILi{n}EEEvNS_8OneQueryI"
                "13__nv_bfloat16EE" for n in (1, 2, 4)]
    lines = [f"ptxas info    : Compiling entry function '{FP32}' for "
             "'sm_90a'", "    0 bytes stack frame, 0 bytes spill stores, "
             "0 bytes spill loads", "ptxas info    : Used 122 registers"]
    for i, name in enumerate(mangled):
        spill = 8 if i == 5 else 0
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  "'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    {spill} bytes stack frame, {spill} bytes spill "
                  f"stores, {spill} bytes spill loads",
                  "ptxas info    : Used 40 registers, used 1 barriers"]
    recs = ops.ptxas_kernels("\n".join(lines))
    assert [r["kernel"] for r in recs] == (["flash_attention_kernel<8>"]
                                           + list(flash_mod.ONE_QUERY_NO_SPILL))
    kept = [r for r in recs if r["kernel"] in flash_mod.ONE_QUERY_NO_SPILL]
    assert [r["spill_stores"] for r in kept] == [0, 0, 0, 0, 0, 8]
    assert all(r["registers"] == 40 for r in kept)


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


def test_backward_sass_gate_takes_wgmma_only(monkeypatch):
    """``tools/flash_bwd_check.py``'s gate: every backward kernel, fp32 and
    bf16, has HGMMA and no HMMA, and the rows and keys kernels of both
    dtypes are there."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "flash_bwd_check.py"
    spec = importlib.util.spec_from_file_location("flash_bwd_check", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rows, keys = (_bwd_mangled(flash_mod.BACKWARD.NO_SPILL[0]),
                  _bwd_mangled(flash_mod.BACKWARD.NO_SPILL[5]))
    rows32, keys32 = (_bwd_mangled(BWD_FP32[1]), _bwd_mangled(BWD_FP32[5]))
    listing = "\n".join([
        "\tcode for sm_90a",
        f"\t\tFunction : {rows}",
        "        /*0200*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;",
        f"\t\tFunction : {keys}",
        "        /*0200*/  HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;",
        "        /*0210*/  HGMMA.64x192x16.F32.BF16 R88, R152, gdesc[UR8], R88, gsb0 ;",
        f"\t\tFunction : {rows32}",
        "        /*0100*/  HGMMA.64x32x8.F32.TF32 R24, R4, gdesc[UR4], RZ, !UPT, gsb0 ;",
        f"\t\tFunction : {keys32}",
        "        /*0100*/  HGMMA.64x64x8.F32.TF32 R24, R4, gdesc[UR4], R24, gsb0 ;"])
    monkeypatch.setattr(ops, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: SimpleNamespace(
        stdout=listing))
    sass = ops.sass_counts("flash_attention_bwd")
    assert sass == {
        flash_mod.BACKWARD.NO_SPILL[0]: {"HGMMA": 1, "HMMA": 0},
        flash_mod.BACKWARD.NO_SPILL[5]: {"HGMMA": 2, "HMMA": 0},
        BWD_FP32[1]: {"HGMMA": 1, "HMMA": 0},
        BWD_FP32[5]: {"HGMMA": 1, "HMMA": 0}}
    assert tool.sass_ok(sass)
    sass[BWD_FP32[5]]["HMMA"] = 1                   # an fp32 mma.sync
    assert not tool.sass_ok(sass)
    sass[BWD_FP32[5]]["HMMA"] = 0
    sass[flash_mod.BACKWARD.NO_SPILL[5]]["HMMA"] = 1    # a bf16 mma.sync
    assert not tool.sass_ok(sass)
    sass[flash_mod.BACKWARD.NO_SPILL[5]]["HMMA"] = 0
    del sass[BWD_FP32[1]]                              # no fp32 rows kernel
    assert not tool.sass_ok(sass)
    sass[BWD_FP32[1]] = {"HGMMA": 1, "HMMA": 0}
    del sass[flash_mod.BACKWARD.NO_SPILL[0]]           # no bf16 rows kernel
    assert not tool.sass_ok(sass)
