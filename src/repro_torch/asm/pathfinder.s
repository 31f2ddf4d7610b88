# pathfinder: RVV v1.0 kernel emitted by repro.core.codegen -- do not edit.
# Decodes (repro.core.rvv) to the jaxpr-lowered trace, bitwise, at
# every effective MVL in {8/16/32/64/128/256}; the .chunk loop's bgtz
# counter encodes the exact fractional trip count.
    .text
    .globl pathfinder
    .stream fp0 1253376.0
    .stream fp1 781.25
pathfinder:
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
    li a3, 20054016
    li a4, 1
    j cfg_done
cfg_16:
    li a3, 10027008
    li a4, 1
    j cfg_done
cfg_32:
    li a3, 5013504
    li a4, 1
    j cfg_done
cfg_64:
    li a3, 2506752
    li a4, 1
    j cfg_done
cfg_128:
    li a3, 1253376
    li a4, 1
    j cfg_done
cfg_256:
    li a3, 626688
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
    .rept 38
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vle64.v v2, (a5)
    vslide1down.vx v3, v1, t5
    vslide1down.vx v4, v1, t5
    vfadd.vv v1, v3, v1
    vfadd.vv v1, v1, v4
    vfadd.vv v0, v1, v0
    vfadd.vv v0, v0, v2
    vslide1down.vx v1, v0, t5
    vslide1down.vx v2, v0, t5
    vfadd.vv v1, v1, v2
    vfadd.vv v0, v1, v0
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vse64.v v0, (a5)
    j close
body_16:
    .rept 38
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vle64.v v2, (a5)
    vslide1down.vx v3, v1, t5
    vslide1down.vx v4, v1, t5
    vfadd.vv v1, v3, v1
    vfadd.vv v1, v1, v4
    vfadd.vv v0, v1, v0
    vfadd.vv v0, v0, v2
    vslide1down.vx v1, v0, t5
    vslide1down.vx v2, v0, t5
    vfadd.vv v1, v1, v2
    vfadd.vv v0, v1, v0
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vse64.v v0, (a5)
    j close
body_32:
    .rept 38
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vle64.v v2, (a5)
    vslide1down.vx v3, v1, t5
    vslide1down.vx v4, v1, t5
    vfadd.vv v1, v3, v1
    vfadd.vv v1, v1, v4
    vfadd.vv v0, v1, v0
    vfadd.vv v0, v0, v2
    vslide1down.vx v1, v0, t5
    vslide1down.vx v2, v0, t5
    vfadd.vv v1, v1, v2
    vfadd.vv v0, v1, v0
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vse64.v v0, (a5)
    j close
body_64:
    .rept 38
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vle64.v v2, (a5)
    vslide1down.vx v3, v1, t5
    vslide1down.vx v4, v1, t5
    vfadd.vv v1, v3, v1
    vfadd.vv v1, v1, v4
    vfadd.vv v0, v1, v0
    vfadd.vv v0, v0, v2
    vslide1down.vx v1, v0, t5
    vslide1down.vx v2, v0, t5
    vfadd.vv v1, v1, v2
    vfadd.vv v0, v1, v0
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vse64.v v0, (a5)
    j close
body_128:
    .rept 38
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vle64.v v2, (a5)
    vslide1down.vx v3, v1, t5
    vslide1down.vx v4, v1, t5
    vfadd.vv v1, v3, v1
    vfadd.vv v1, v1, v4
    vfadd.vv v0, v1, v0
    vfadd.vv v0, v0, v2
    vslide1down.vx v1, v0, t5
    vslide1down.vx v2, v0, t5
    vfadd.vv v1, v1, v2
    vfadd.vv v0, v1, v0
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vse64.v v0, (a5)
    j close
body_256:
    .rept 38
    add s5, s5, s6
    .endr
    la a5, fp0
    vle64.v v0, (a5)
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vle64.v v2, (a5)
    vslide1down.vx v3, v1, t5
    vslide1down.vx v4, v1, t5
    vfadd.vv v1, v3, v1
    vfadd.vv v1, v1, v4
    vfadd.vv v0, v1, v0
    vfadd.vv v0, v0, v2
    vslide1down.vx v1, v0, t5
    vslide1down.vx v2, v0, t5
    vfadd.vv v1, v1, v2
    vfadd.vv v0, v1, v0
    la a5, fp1
    vle64.v v1, (a5)
    la a5, fp1
    vse64.v v0, (a5)
    j close
close:
    sub a3, a3, a4
    bgtz a3, loop
    ret
