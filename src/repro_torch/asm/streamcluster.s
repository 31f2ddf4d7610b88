# streamcluster: RVV v1.0 kernel emitted by repro.core.codegen -- do not edit.
# Decodes (repro.core.rvv) to the jaxpr-lowered trace, bitwise, at
# every effective MVL in {8/16/32/64/128}; the .chunk loop's bgtz
# counter encodes the exact fractional trip count.
    .text
    .globl streamcluster
    .stream fp0 768.0
streamcluster:
    vsetvli t0, zero, e64, m1
    vmv.v.i v20, 0
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
    j vl_bad
cfg_8:
    li a3, 59533158
    li a4, 1
    j cfg_done
cfg_16:
    li a3, 59533158
    li a4, 1
    j cfg_done
cfg_32:
    li a3, 59533158
    li a4, 1
    j cfg_done
cfg_64:
    li a3, 59533158
    li a4, 1
    j cfg_done
cfg_128:
    li a3, 59533158
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
    j vl_bad
body_8:
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vv v0, v0, v0
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 30
    add s4, s5, s3
    .endr
    j close
body_16:
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vv v0, v0, v0
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 30
    add s4, s5, s3
    .endr
    j close
body_32:
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vv v0, v0, v0
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 30
    add s4, s5, s3
    .endr
    j close
body_64:
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vv v0, v0, v0
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v1, (a5)
    vfmul.vv v0, v0, v1
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 30
    add s4, s5, s3
    .endr
    j close
body_128:
    .rept 2
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    vfmul.vv v0, v0, v0
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 30
    add s4, s5, s3
    .endr
    j close
close:
    sub a3, a3, a4
    bgtz a3, loop
    ret
