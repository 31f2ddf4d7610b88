# jacobi-2d: RVV v1.0 kernel emitted by repro.core.codegen -- do not edit.
# Decodes (repro.core.rvv) to the jaxpr-lowered trace, bitwise, at
# every effective MVL in {8/16/32/64/128/256}; the .chunk loop's bgtz
# counter encodes the exact fractional trip count.
    .text
    .globl jacobi_2d
    .stream fp0 408.0
jacobi_2d:
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
    li a3, 13056000
    li a4, 1
    j cfg_done
cfg_16:
    li a3, 6528000
    li a4, 1
    j cfg_done
cfg_32:
    li a3, 3264000
    li a4, 1
    j cfg_done
cfg_64:
    li a3, 1632000
    li a4, 1
    j cfg_done
cfg_128:
    li a3, 816000
    li a4, 1
    j cfg_done
cfg_256:
    li a3, 408000
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
    .rept 87
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    vslide1down.vx v1, v0, t5
    vslide1down.vx v0, v0, t5
    vfmul.vf v0, ft0, ft1
    vid.v v1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfmul.vv v2, v7, v2
    vfmul.vv v3, v8, v3
    vslide1down.vx v0, v0, t5
    vslide1down.vx v1, v1, t5
    vslide1down.vx v1, v2, t5
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_16:
    .rept 87
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    vslide1down.vx v1, v0, t5
    vslide1down.vx v0, v0, t5
    vfmul.vf v0, ft0, ft1
    vid.v v1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfmul.vv v2, v7, v2
    vfmul.vv v3, v8, v3
    vslide1down.vx v0, v0, t5
    vslide1down.vx v1, v1, t5
    vslide1down.vx v1, v2, t5
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_32:
    .rept 87
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    vslide1down.vx v1, v0, t5
    vslide1down.vx v0, v0, t5
    vfmul.vf v0, ft0, ft1
    vid.v v1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfmul.vv v2, v7, v2
    vfmul.vv v3, v8, v3
    vslide1down.vx v0, v0, t5
    vslide1down.vx v1, v1, t5
    vslide1down.vx v1, v2, t5
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_64:
    .rept 87
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    vslide1down.vx v1, v0, t5
    vslide1down.vx v0, v0, t5
    vfmul.vf v0, ft0, ft1
    vid.v v1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfmul.vv v2, v7, v2
    vfmul.vv v3, v8, v3
    vslide1down.vx v0, v0, t5
    vslide1down.vx v1, v1, t5
    vslide1down.vx v1, v2, t5
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_128:
    .rept 87
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    vslide1down.vx v1, v0, t5
    vslide1down.vx v0, v0, t5
    vfmul.vf v0, ft0, ft1
    vid.v v1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfmul.vv v2, v7, v2
    vfmul.vv v3, v8, v3
    vslide1down.vx v0, v0, t5
    vslide1down.vx v1, v1, t5
    vslide1down.vx v1, v2, t5
    la a5, fp0
    vse64.v v0, (a5)
    j close
body_256:
    .rept 87
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    la a5, fp0
    vle64.v v1, (a5)
    vslide1down.vx v1, v0, t5
    vslide1down.vx v0, v0, t5
    vfmul.vf v0, ft0, ft1
    vid.v v1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfmul.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfmul.vv v2, v7, v2
    vfmul.vv v3, v8, v3
    vslide1down.vx v0, v0, t5
    vslide1down.vx v1, v1, t5
    vslide1down.vx v1, v2, t5
    la a5, fp0
    vse64.v v0, (a5)
    j close
close:
    sub a3, a3, a4
    bgtz a3, loop
    ret
