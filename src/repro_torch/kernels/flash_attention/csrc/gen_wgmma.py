"""Write ``wgmma_ops.cuh``: inline-PTX wrappers for the Hopper ``wgmma``
shapes the port's tensor-core kernels issue (flash attention here, the
SSD scan in ``ssd_scan/csrc/ssd_wgmma.cu``).

    python3 src/repro_torch/kernels/flash_attention/csrc/gen_wgmma.py

A ``wgmma.mma_async`` names every accumulator register of the
warpgroup's 64 x N f32 tile (N / 2 per thread), so each N needs its own
operand list; this script spells them out. Two families:

- ``wgmma_ss<N>(d, desc_a, desc_b, scale_d)``: m64nNk16, bf16 x bf16 ->
  f32, A and B from shared memory, both K-major (S = Q K^T).
- ``wgmma_rs<N>(d, a, desc_b)``: m64nNk16, A from four registers of
  packed bf16 pairs, B from shared memory N-major (the transposed-B bit
  set), accumulating (O += P V).
- ``wgmma_ss_tt<N>(d, desc_a, desc_b, scale_d)``: m64nNk16, A M-major and
  B N-major in shared memory (both transpose bits set): a product over
  the rows of two row-major tiles (the SSD state's X^T B).

The header is committed; ``tests/test_torch_flash_attention.py`` checks
that it matches this script's output.
"""

from __future__ import annotations

from pathlib import Path

SS_WIDTHS = (64, 128)                 # S tile widths: BN
RS_WIDTHS = tuple(range(16, 193, 16))  # O tile widths: every head dim
SS_TT_WIDTHS = (64,)                  # SSD state columns per warpgroup
HEADER = Path(__file__).with_name("wgmma_ops.cuh")


def _regs(first: int, n: int) -> str:
    return ", ".join(f"%{first + i}" for i in range(n))


def _outs(n: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def ss(n: int, name: str = "wgmma_ss", trans: str = "0, 0") -> str:
    r = n // 2
    pad = " " * (len(name) - len("wgmma_ss"))
    return f"""template <>
__device__ __forceinline__ void {name}<{n}>(float (&d)[{r}], uint64_t desc_a,
                                             {pad}uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(0, r)}}}, %{r}, %{r + 1}, p, 1, 1, {trans};\\n}}\\n"
      : {_outs(r)}
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}}
"""


def ss_tt(n: int) -> str:
    return ss(n, "wgmma_ss_tt", "1, 1")


def rs(n: int) -> str:
    r = n // 2
    return f"""template <>
__device__ __forceinline__ void wgmma_rs<{n}>(float (&d)[{r}],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(0, r)}}}, {{{_regs(r, 4)}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
      : {_outs(r)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}}
"""


def render() -> str:
    parts = [
        "// Generated by gen_wgmma.py in this directory; do not edit.\n"
        "// Inline-PTX wgmma.mma_async wrappers (sm_90a), bf16 x bf16 to f32.\n"
        "#pragma once\n#include <stdint.h>\n\n"
        "// m64nNk16, A and B K-major in shared memory; scale_d 0 overwrites\n"
        "template <int N>\n"
        "__device__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,\n"
        "                         uint64_t desc_b, int scale_d);\n"
        "// m64nNk16, A from registers, B N-major in shared memory; d += A B\n"
        "template <int N>\n"
        "__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],\n"
        "                         uint64_t desc_b);\n"
        "// m64nNk16, A M-major and B N-major in shared memory; scale_d 0\n"
        "// overwrites\n"
        "template <int N>\n"
        "__device__ void wgmma_ss_tt(float (&d)[N / 2], uint64_t desc_a,\n"
        "                            uint64_t desc_b, int scale_d);\n\n"
    ]
    parts += [ss(n) + "\n" for n in SS_WIDTHS]
    parts += [rs(n) + "\n" for n in RS_WIDTHS]
    parts += [ss_tt(n) + "\n" for n in SS_TT_WIDTHS]
    return "".join(parts).rstrip() + "\n"


if __name__ == "__main__":
    HEADER.write_text(render())
