"""Where the bf16 whole-block Swin kernel spends its cycles, by clock64 probes.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/probe_torch_swin_block.py

It copies ``eqxvision_tpu_torch`` into ``eqxvision_tpu_torch/_build/probe/``,
adds ``clock64()`` probes at the phase boundaries of the bf16 kernel in that
copy's ``csrc/swin_block.cu`` (each probe is placed at one whole source
line, which must occur exactly once, or the script stops), builds it, and
runs the NHWC entry ``fused_swin_block_v1`` once at swin_t stages 1 and 2
(b128, 224 px, window 7, shifted). Each warpgroup sums the cycles its
first thread spends in each phase; the script prints the sums per window:
the phases in order, then the MLP's parts, then two waits counted inside
the phases (for a weight stage to arrive, and for the MLP's products).
The probes cost a few cycles each, so the total is close to, not equal
to, the unprobed kernel's. Imports nothing of JAX.
"""
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "eqxvision_tpu_torch"
COPY = PKG / "_build" / "probe"

PHASES = {0: "between windows", 1: "load + LN1", 8: "qkv products", 9: "attention", 2: "qkv/attention rest",
          3: "proj + LN2", 11: "MLP: b_fc1, wait, releases", 12: "MLP: gelu", 13: "MLP: hidden tile store, barriers",
          14: "MLP: fc2 issue", 15: "MLP: fc1 issue", 4: "MLP end, output staging", 5: "store"}
NESTED = {6: "of all: waits for a weight stage", 7: "of the MLP: waits for its products"}
# (whole source line, where the probe goes, probe number)
MARKS = [
    ("    sync_wg();  // the previous window's readers of every buffer are done", "before", 0),
    ("    // ---- qkv by pieces of 64 / Dh heads, each piece's attention after it", "before", 1),
    ("      load_bias(j * hp);", "before", 8),
    ('      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");  // O\'s generic writes, then proj\'s wgmma',
     "before", 9),
    ("    // ---- proj, the first residual and the MLP input", "before", 2),
    ("    // ---- the MLP by hidden chunks. fc1 of a chunk into a1, gelu into the", "before", 3),
    ("      release();              // this chunk's fc1 stage", "after", 11),
    ("      sync_wg();  // every warp's fc2 of the last chunk has read the hidden tile", "before", 12),
    ("      if (ch + 1 < n_chunks) issue_fc1();", "before", 14),
    ("      if (ch + 1 < n_chunks) issue_fc1();", "after", 15),
    ("    // ---- out = h + y (v1, already in acc) or h + LN2(y + b2) (v2)", "before", 4),
]
# the hidden tile's barriers end where fc2's stage wait and issue begin
FC2_START = "        unsigned char* st = wait_stage();"
STAGE_WAIT = "    mbar_wait(&full[next % stages], (next / stages) & 1);"
MLP_WAIT = "      wgmma_wait<0>();  // fc1 of this chunk and fc2 of the last are done"
STORE_LOOP = "    for (int i = wt; i < kRows * (C / 8); i += kWarpgroup) {"
GROUP_LOOP = "  uint32_t next = 0, freed = 0;"
NAMESPACE = "namespace {\n\nusing bf16 = __nv_bfloat16;"
KERNEL_END = "\n  }\n}\n\n// The N of proj's and fc2's wgmma for a C"

RUN = """
import ctypes, sys, torch
sys.path.insert(0, sys.argv[1])
from eqxvision_tpu_torch import _native
from eqxvision_tpu_torch.ops import window_attention as W
phases, nested = {phases}, {nested}
lib = _native.library()
lib.eqx_probe_read.argtypes = [ctypes.c_void_p]
gen = torch.Generator(device="cuda").manual_seed(0)
for name, side, win, c, h in [("swin_t stage 1", 56, 7, 96, 3), ("swin_t stage 2", 28, 7, 192, 6)]:
    def r(*shape, s=0.1, base=0.0):
        return base + s * torch.randn(*shape, device="cuda", generator=gen)
    hid = 4 * c
    kw = dict(norm1_w=r(c, base=1.0), norm1_b=r(c), qkv_weight=r(3 * c, c).bfloat16(), qkv_bias=r(3 * c),
              proj_weight=r(c, c).bfloat16(), proj_bias=r(c), norm2_w=r(c, base=1.0), norm2_b=r(c),
              fc1_weight=r(hid, c).bfloat16(), fc1_bias=r(hid), fc2_weight=r(c, hid).bfloat16(), fc2_bias=r(c),
              relative_position_bias=r(1, h, win * win, win * win, s=1.0), window_size=(win, win),
              shift_size=(win // 2, win // 2), num_heads=h)
    x = r(128, side, side, c, s=0.5).bfloat16()
    with torch.inference_mode():
        W.fused_swin_block_v1(x, **kw)
        torch.cuda.synchronize()
        lib.eqx_probe_zero()
        W.fused_swin_block_v1(x, **kw)
        torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    lib.eqx_probe_read(ctypes.addressof(buf))
    windows = 128 * (side // win) ** 2
    total = sum(buf[k] for k in phases) / windows
    print(f"{{name}} (128, {{side}}, {{side}}, {{c}}): {{total / 1e3:.1f}}k cycles a window and warpgroup", flush=True)
    for k, what in list(phases.items()) + list(nested.items()):
        print(f"  {{what:40s}} {{buf[k] / windows / 1e3:8.2f}}k", flush=True)
"""


def insert(text, line, where, code):
    lines = text.split("\n")
    hits = [i for i, have in enumerate(lines) if have == line]
    if len(hits) != 1:
        raise SystemExit(f"the line to probe occurs {len(hits)} times in swin_block.cu: {line!r}")
    lines.insert(hits[0] + (where == "after"), code)
    return "\n".join(lines)


def probed(text):
    indent = lambda line: " " * (len(line) - len(line.lstrip()))  # noqa: E731
    for line, where, k in MARKS:
        text = insert(text, line, where, f"{indent(line)}PROBE({k});")
    text = insert(text, FC2_START, "before", "        PROBE(13);")
    text = insert(text, STAGE_WAIT, "before", "    const long long wait0 = clock64();")
    text = insert(text, STAGE_WAIT, "after", "    probe_acc[6] += clock64() - wait0;")
    text = insert(text, MLP_WAIT, "before", "      const long long wait1 = clock64();")
    text = insert(text, MLP_WAIT, "after", "      probe_acc[7] += clock64() - wait1;")
    i = text.index(STORE_LOOP)
    j = text.index("\n    }\n", i) + len("\n    }\n")
    text = text[:j] + "    PROBE(5);\n" + text[j:]
    text = insert(text, GROUP_LOOP, "before",
                  "  long long probe_t = clock64(), probe_acc[16] = {};\n"
                  "#define PROBE(k) { const long long now = clock64(); probe_acc[k] += now - probe_t; probe_t = now; }")
    if text.count(NAMESPACE) != 1 or text.count(KERNEL_END) != 1:
        raise SystemExit("swin_block.cu's namespace or bf16 kernel end is not where the probes expect it")
    text = text.replace(NAMESPACE, "__device__ unsigned long long g_probe[16];\n" + NAMESPACE)
    text = text.replace(KERNEL_END, "\n  }\n  if (threadIdx.x % kWarpgroup == 0)\n"
                        "    for (int q = 0; q < 16; ++q) atomicAdd(&g_probe[q], (unsigned long long)probe_acc[q]);\n"
                        "}\n\n// The N of proj's and fc2's wgmma for a C")
    return text.replace('extern "C" {', 'extern "C" {\n'
                        "int eqx_probe_read(unsigned long long* host) {\n"
                        "  return cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));\n}\n"
                        "int eqx_probe_zero() {\n  unsigned long long z[16] = {};\n"
                        "  return cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n}", 1)


def main():
    text = probed((PKG / "csrc" / "swin_block.cu").read_text())  # stops on a stale line before any copy
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(PKG, COPY / PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (COPY / PKG.name / "csrc" / "swin_block.cu").write_text(text)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    code = RUN.format(phases=PHASES, nested=NESTED)
    return subprocess.run([sys.executable, "-c", code, str(COPY)]).returncode


if __name__ == "__main__":
    sys.exit(main())
