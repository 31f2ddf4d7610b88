# flash_attention: RVV v1.0 kernel emitted by repro.core.codegen -- do not edit.
# Decodes (repro.core.rvv) to the jaxpr-lowered trace, bitwise, at
# every effective MVL in {8/16/32/64/128/256}; the .chunk loop's bgtz
# counter encodes the exact fractional trip count.
    .text
    .globl flash_attention
    .stream fp0 512.0
flash_attention:
    vsetvli t0, zero, e64, m1
    vmv.v.i v0, 0
    vcpop.m s3, v0
    li t1, 8
    beq t0, t1, cfg_8
    li t1, 16
    beq t0, t1, cfg_16
    li t1, 32
    beq t0, t1, cfg_32
    li t1, 64
    beq t0, t1, cfg_64
    li t1, 128
    beq t0, t1, cfg_128
    li t1, 256
    beq t0, t1, cfg_256
    j vl_bad
cfg_8:
    li a3, 8388608
    li a4, 1
    j cfg_done
cfg_16:
    li a3, 4194304
    li a4, 1
    j cfg_done
cfg_32:
    li a3, 2097152
    li a4, 1
    j cfg_done
cfg_64:
    li a3, 1048576
    li a4, 1
    j cfg_done
cfg_128:
    li a3, 524288
    li a4, 1
    j cfg_done
cfg_256:
    li a3, 262144
    li a4, 1
    j cfg_done
vl_bad:
    call abort
cfg_done:
    .chunk
loop:
    li t1, 8
    beq t0, t1, body_8
    li t1, 16
    beq t0, t1, body_16
    li t1, 32
    beq t0, t1, body_32
    li t1, 64
    beq t0, t1, body_64
    li t1, 128
    beq t0, t1, body_128
    li t1, 256
    beq t0, t1, body_256
    j vl_bad
body_8:
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vf v0, v0, ft0
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    vfadd.vv v0, v0, v1
    vfexp.v v0, v0
    vfredusum.vs v1, v0, v0
    .rept 6
    add s4, s5, s3
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_16:
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vf v0, v0, ft0
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    vfadd.vv v0, v0, v1
    vfexp.v v0, v0
    vfredusum.vs v1, v0, v0
    .rept 6
    add s4, s5, s3
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_32:
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vf v0, v0, ft0
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    vfadd.vv v0, v0, v1
    vfexp.v v0, v0
    vfredusum.vs v1, v0, v0
    .rept 6
    add s4, s5, s3
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_64:
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vf v0, v0, ft0
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    vfadd.vv v0, v0, v1
    vfexp.v v0, v0
    vfredusum.vs v1, v0, v0
    .rept 6
    add s4, s5, s3
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_128:
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vf v0, v0, ft0
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    vfadd.vv v0, v0, v1
    vfexp.v v0, v0
    vfredusum.vs v1, v0, v0
    .rept 6
    add s4, s5, s3
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_256:
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vf v0, v0, ft0
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vf v1, v1, ft0
    vfadd.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    vfadd.vv v0, v0, v1
    vfexp.v v0, v0
    vfredusum.vs v1, v0, v0
    .rept 6
    add s4, s5, s3
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v1, v0, v1
    vfredusum.vs v1, v1, v1
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v1, v0, v0
    la a5, fp0
    vse64.v v0, (a5)
    j close
close:
    sub a3, a3, a4
    bgtz a3, loop
    ret
