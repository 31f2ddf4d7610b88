"""Instruction-level characterization (paper §4, Tables 3-9) and VAO speedups.

The port of ``repro/core/characterize.py`` (host Python, unchanged).

Definitions (paper §4.1.1):
  %vectorization = vector_ops / (scalar_instrs + vector_ops)
  average VL     = vector_ops / total_vector_instrs
  VAO speedup    = scalar_code_total / (scalar_instrs + vector_ops)
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.tracegen import APPS, Counts

# The paper's published table cells used as regression goldens:
# app -> mvl -> (total_instr, scalar, vec_mem, vec_arith(+manip+moves), vec_ops)
PAPER_TABLES = {
    "blackscholes": {  # Table 3
        8: (727_119_128, 484_635_928, 22_118_400, 220_364_800, 1_939_865_600),
        64: (342_504_727, 312_194_327, 2_764_800, 27_545_600, 1_939_865_600),
        256: (298_856_749, 291_279_149, 691_200, 6_886_400, 1_939_865_600),
    },
    "canneal": {  # Table 4
        8: (3_722_402_159, 3_368_424_160, 59_887_894, 294_090_105, 2_450_191_462),
        16: (3_490_359_558, 3_218_719_265, 37_432_156, 234_208_137, 3_102_641_472),
        32: (3_488_680_211, 3_217_635_854, 37_269_628, 233_774_729, 4_078_370_559),
        64: (3_488_680_211, 3_217_635_854, 37_269_628, 233_774_729, 6_030_736_943),
        128: (3_488_680_211, 3_217_635_854, 37_269_628, 233_774_729, 9_926_999_575),
        256: (3_488_680_211, 3_217_635_854, 37_269_628, 233_774_729, 17_727_994_975),
    },
    "jacobi-2d": {  # Table 5 (arith column = arith + elem-manip)
        8: (1_665_765_868, 1_275_617_868, 65_280_000, 324_868_000, 3_121_184_000),
        64: (328_373_875, 279_601_875, 8_160_000, 40_612_000, 3_121_408_000),
        256: (185_081_872, 172_885_872, 2_040_000, 10_156_000, 3_122_176_000),
    },
    "particlefilter": {  # Table 6
        8: (4_993_215_636, 3_446_128_079, 1_607_712, 1_545_479_845, 12_376_700_456),
        64: (1_617_632_096, 1_423_641_027, 200_992, 193_790_077, 12_415_428_416),
        256: (1_260_531_622, 1_211_546_181, 50_272, 48_935_169, 12_540_272_896),
    },
    "pathfinder": {  # Table 7 (arith column = arith + elem-manip)
        8: (1_337_948_580, 1_037_138_340, 100_270_080, 200_540_160, 2_406_481_920),
        64: (402_094_500, 364_493_220, 12_533_760, 25_067_520, 2_406_481_920),
        256: (301_824_392, 292_424_072, 3_133_440, 6_266_880, 2_406_481_920),
    },
    "streamcluster": {  # Table 8
        8: (6_349_730_434, 4_325_602_994, 952_530_560, 1_071_596_880, 16_193_019_520),
        64: (2_599_142_070, 2_241_943_122, 119_066_316, 238_132_632, 22_860_732_672),
        128: (2_331_242_835, 2_093_110_203, 59_533_158, 178_599_474, 30_480_976_896),
    },
    "swaptions": {  # Table 9
        8: (6_337_441_159, 4_173_151_623, 370_323_456, 1_793_966_080, 17_314_316_288),
        64: (1_022_467_455, 751_931_263, 46_290_432, 224_245_760, 17_314_316_288),
        256: (456_078_412, 388_444_364, 11_572_608, 56_061_440, 17_314_316_288),
    },
}

# VAO speedups quoted in §4.1.x (at MVL=8 unless noted)
PAPER_VAO = {
    "blackscholes": 1.78,
    "canneal": 0.90,
    "jacobi-2d": 1.09,
    "particlefilter": 1.27,
    "pathfinder": 1.8,
    "streamcluster": 1.75,
    "swaptions": 1.24,
}


@dataclass
class Characterization:
    app: str
    mvl: int
    counts: Counts

    @property
    def pct_vectorization(self) -> float:
        c = self.counts
        return c.vector_ops / (c.scalar_instrs + c.vector_ops)

    @property
    def avg_vl(self) -> float:
        c = self.counts
        return c.vector_ops / max(c.total_vector, 1)

    @property
    def vao_speedup(self) -> float:
        c = self.counts
        return c.scalar_code_total / (c.scalar_instrs + c.vector_ops)

    def row(self) -> dict:
        c = self.counts
        return {
            "app": self.app, "mvl": self.mvl,
            "total_instructions": c.total_instrs,
            "scalar_instructions": c.scalar_instrs,
            "vector_memory_instructions": c.vector_mem,
            "vector_arith_instructions": c.vector_arith + c.vector_manip,
            "total_vector_instructions": c.total_vector,
            "vector_operations": c.vector_ops,
            "pct_vectorization": self.pct_vectorization,
            "average_vl": self.avg_vl,
            "vao_speedup": self.vao_speedup,
        }


def characterize(app: str, mvl: int) -> Characterization:
    return Characterization(app, mvl, APPS[app].counts(mvl))


def table(app: str, mvls=(8, 16, 32, 64, 128, 256)) -> list[dict]:
    return [characterize(app, m).row() for m in mvls]


def compare_to_paper(app: str) -> list[dict]:
    """Model-vs-published relative errors for every golden cell."""
    out = []
    for mvl, (tot, sc, mem, arith, ops) in PAPER_TABLES[app].items():
        c = characterize(app, mvl).counts
        def err(model, paper):
            return abs(model - paper) / paper
        out.append({
            "app": app, "mvl": mvl,
            "err_total": err(c.total_instrs, tot),
            "err_scalar": err(c.scalar_instrs, sc),
            "err_mem": err(c.vector_mem, mem),
            "err_arith": err(c.vector_arith + c.vector_manip, arith),
            "err_ops": err(c.vector_ops, ops),
        })
    return out
