# swaptions: RVV v1.0 kernel emitted by repro.core.codegen -- do not edit.
# Decodes (repro.core.rvv) to the jaxpr-lowered trace, bitwise, at
# every effective MVL in {8/16/32/64/128/256}; the .chunk loop's bgtz
# counter encodes the exact fractional trip count.
    .text
    .globl swaptions
    .stream fp0 21.875
    .stream fp1 43.75
    .stream fp2 87.5
    .stream fp3 175.0
    .stream fp4 350.0
    .stream fp5 700.0
swaptions:
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
    li a3, 1252094932138337
    li a4, 16777216
    j cfg_done
cfg_16:
    li a3, 1252094932138337
    li a4, 33554432
    j cfg_done
cfg_32:
    li a3, 1252094932138337
    li a4, 67108864
    j cfg_done
cfg_64:
    li a3, 1252094932138337
    li a4, 134217728
    j cfg_done
cfg_128:
    li a3, 1252094932138337
    li a4, 268435456
    j cfg_done
cfg_256:
    li a3, 1252094932138337
    li a4, 536870912
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
    .rept 52
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
    vid.v v0
    vid.v v1
    vfexp.v v2, ft0
    vfmul.vf v3, v0, ft0
    vfmul.vf v4, v1, ft0
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfexp.v v2, v4
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfadd.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfmul.vv v0, v2, v0
    vfadd.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfdiv.vv v1, v3, v1
    vfmul.vv v1, v4, v2
    vfadd.vv v0, v0, v3
    la a5, fp0
    vse64.v v1, (a5)
    j close
body_16:
    .rept 52
    add s5, s5, s6
    .endr
    la a5, fp1
    vle64.v v0, (a5)
    la a5, fp1
    vle64.v v0, (a5)
    la a5, fp1
    vle64.v v0, (a5)
    la a5, fp1
    vle64.v v0, (a5)
    vid.v v0
    vid.v v1
    vfexp.v v2, ft0
    vfmul.vf v3, v0, ft0
    vfmul.vf v4, v1, ft0
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfexp.v v2, v4
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfadd.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfmul.vv v0, v2, v0
    vfadd.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfdiv.vv v1, v3, v1
    vfmul.vv v1, v4, v2
    vfadd.vv v0, v0, v3
    la a5, fp1
    vse64.v v1, (a5)
    j close
body_32:
    .rept 52
    add s5, s5, s6
    .endr
    la a5, fp2
    vle64.v v0, (a5)
    la a5, fp2
    vle64.v v0, (a5)
    la a5, fp2
    vle64.v v0, (a5)
    la a5, fp2
    vle64.v v0, (a5)
    vid.v v0
    vid.v v1
    vfexp.v v2, ft0
    vfmul.vf v3, v0, ft0
    vfmul.vf v4, v1, ft0
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfexp.v v2, v4
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfadd.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfmul.vv v0, v2, v0
    vfadd.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfdiv.vv v1, v3, v1
    vfmul.vv v1, v4, v2
    vfadd.vv v0, v0, v3
    la a5, fp2
    vse64.v v1, (a5)
    j close
body_64:
    .rept 52
    add s5, s5, s6
    .endr
    la a5, fp3
    vle64.v v0, (a5)
    la a5, fp3
    vle64.v v0, (a5)
    la a5, fp3
    vle64.v v0, (a5)
    la a5, fp3
    vle64.v v0, (a5)
    vid.v v0
    vid.v v1
    vfexp.v v2, ft0
    vfmul.vf v3, v0, ft0
    vfmul.vf v4, v1, ft0
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfexp.v v2, v4
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfadd.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfmul.vv v0, v2, v0
    vfadd.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfdiv.vv v1, v3, v1
    vfmul.vv v1, v4, v2
    vfadd.vv v0, v0, v3
    la a5, fp3
    vse64.v v1, (a5)
    j close
body_128:
    .rept 52
    add s5, s5, s6
    .endr
    la a5, fp4
    vle64.v v0, (a5)
    la a5, fp4
    vle64.v v0, (a5)
    la a5, fp4
    vle64.v v0, (a5)
    la a5, fp4
    vle64.v v0, (a5)
    vid.v v0
    vid.v v1
    vfexp.v v2, ft0
    vfmul.vf v3, v0, ft0
    vfmul.vf v4, v1, ft0
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfexp.v v2, v4
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfadd.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfmul.vv v0, v2, v0
    vfadd.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfdiv.vv v1, v3, v1
    vfmul.vv v1, v4, v2
    vfadd.vv v0, v0, v3
    la a5, fp4
    vse64.v v1, (a5)
    j close
body_256:
    .rept 52
    add s5, s5, s6
    .endr
    la a5, fp5
    vle64.v v0, (a5)
    la a5, fp5
    vle64.v v0, (a5)
    la a5, fp5
    vle64.v v0, (a5)
    la a5, fp5
    vle64.v v0, (a5)
    vid.v v0
    vid.v v1
    vfexp.v v2, ft0
    vfmul.vf v3, v0, ft0
    vfmul.vf v4, v1, ft0
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfexp.v v2, v4
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfmul.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfadd.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfmul.vv v0, v2, v0
    vfadd.vv v1, v3, v1
    vfadd.vv v2, v4, v2
    vfmul.vv v3, v0, v3
    vfadd.vv v4, v1, v4
    vfadd.vv v0, v2, v0
    vfdiv.vv v1, v3, v1
    vfmul.vv v1, v4, v2
    vfadd.vv v0, v0, v3
    la a5, fp5
    vse64.v v1, (a5)
    j close
close:
    sub a3, a3, a4
    bgtz a3, loop
    ret
