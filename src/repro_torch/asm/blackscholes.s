# blackscholes: RVV v1.0 kernel emitted by repro.core.codegen -- do not edit.
# Decodes (repro.core.rvv) to the jaxpr-lowered trace, bitwise, at
# every effective MVL in {8/16/32/64/128/256}; the .chunk loop's bgtz
# counter encodes the exact fractional trip count.
    .text
    .globl blackscholes
    .stream fp0 13824.0
blackscholes:
    vsetvli t0, zero, e64, m1
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
    li a3, 819200
    li a4, 1
    j cfg_done
cfg_16:
    li a3, 409600
    li a4, 1
    j cfg_done
cfg_32:
    li a3, 204800
    li a4, 1
    j cfg_done
cfg_64:
    li a3, 102400
    li a4, 1
    j cfg_done
cfg_128:
    li a3, 51200
    li a4, 1
    j cfg_done
cfg_256:
    li a3, 25600
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
    .rept 244
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    vfdiv.vf v0, ft0, ft1
    vfmul.vf v1, ft0, ft1
    vid.v v2
    vfmul.vf v3, ft0, ft1
    vfmul.vf v4, ft0, ft1
    vfadd.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v0, v1, v7
    vfadd.vv v0, v2, v8
    vfadd.vv v0, v3, v9
    vfmul.vv v0, v4, v10
    la a5, fp0
    vse64.v v3, (a5)
    la a5, fp0
    vse64.v v4, (a5)
    la a5, fp0
    vse64.v v5, (a5)
    la a5, fp0
    vse64.v v6, (a5)
    la a5, fp0
    vse64.v v7, (a5)
    j close
body_16:
    .rept 244
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    vfdiv.vf v0, ft0, ft1
    vfmul.vf v1, ft0, ft1
    vid.v v2
    vfmul.vf v3, ft0, ft1
    vfmul.vf v4, ft0, ft1
    vfadd.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v0, v1, v7
    vfadd.vv v0, v2, v8
    vfadd.vv v0, v3, v9
    vfmul.vv v0, v4, v10
    la a5, fp0
    vse64.v v3, (a5)
    la a5, fp0
    vse64.v v4, (a5)
    la a5, fp0
    vse64.v v5, (a5)
    la a5, fp0
    vse64.v v6, (a5)
    la a5, fp0
    vse64.v v7, (a5)
    j close
body_32:
    .rept 244
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    vfdiv.vf v0, ft0, ft1
    vfmul.vf v1, ft0, ft1
    vid.v v2
    vfmul.vf v3, ft0, ft1
    vfmul.vf v4, ft0, ft1
    vfadd.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v0, v1, v7
    vfadd.vv v0, v2, v8
    vfadd.vv v0, v3, v9
    vfmul.vv v0, v4, v10
    la a5, fp0
    vse64.v v3, (a5)
    la a5, fp0
    vse64.v v4, (a5)
    la a5, fp0
    vse64.v v5, (a5)
    la a5, fp0
    vse64.v v6, (a5)
    la a5, fp0
    vse64.v v7, (a5)
    j close
body_64:
    .rept 244
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    vfdiv.vf v0, ft0, ft1
    vfmul.vf v1, ft0, ft1
    vid.v v2
    vfmul.vf v3, ft0, ft1
    vfmul.vf v4, ft0, ft1
    vfadd.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v0, v1, v7
    vfadd.vv v0, v2, v8
    vfadd.vv v0, v3, v9
    vfmul.vv v0, v4, v10
    la a5, fp0
    vse64.v v3, (a5)
    la a5, fp0
    vse64.v v4, (a5)
    la a5, fp0
    vse64.v v5, (a5)
    la a5, fp0
    vse64.v v6, (a5)
    la a5, fp0
    vse64.v v7, (a5)
    j close
body_128:
    .rept 244
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    vfdiv.vf v0, ft0, ft1
    vfmul.vf v1, ft0, ft1
    vid.v v2
    vfmul.vf v3, ft0, ft1
    vfmul.vf v4, ft0, ft1
    vfadd.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v0, v1, v7
    vfadd.vv v0, v2, v8
    vfadd.vv v0, v3, v9
    vfmul.vv v0, v4, v10
    la a5, fp0
    vse64.v v3, (a5)
    la a5, fp0
    vse64.v v4, (a5)
    la a5, fp0
    vse64.v v5, (a5)
    la a5, fp0
    vse64.v v6, (a5)
    la a5, fp0
    vse64.v v7, (a5)
    j close
body_256:
    .rept 244
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v0, (a5)
    vfdiv.vf v0, ft0, ft1
    vfmul.vf v1, ft0, ft1
    vid.v v2
    vfmul.vf v3, ft0, ft1
    vfmul.vf v4, ft0, ft1
    vfadd.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v0, v1, v7
    vfadd.vv v0, v2, v8
    vfadd.vv v0, v3, v9
    vfmul.vv v0, v4, v10
    la a5, fp0
    vse64.v v3, (a5)
    la a5, fp0
    vse64.v v4, (a5)
    la a5, fp0
    vse64.v v5, (a5)
    la a5, fp0
    vse64.v v6, (a5)
    la a5, fp0
    vse64.v v7, (a5)
    j close
close:
    sub a3, a3, a4
    bgtz a3, loop
    ret
