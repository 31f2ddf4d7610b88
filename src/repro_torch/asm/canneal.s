# canneal: RVV v1.0 kernel emitted by repro.core.codegen -- do not edit.
# Decodes (repro.core.rvv) to the jaxpr-lowered trace, bitwise, at
# every effective MVL in {8/16/22}; the .chunk loop's bgtz
# counter encodes the exact fractional trip count.
    .text
    .globl canneal
    .stream fp0 3072.0
canneal:
    vsetvli t0, zero, e64, m1
    vmv.v.i v0, 0
    vmv.v.i v1, 0
    vmv.v.i v2, 0
    vmv.v.i v3, 0
    vmv.v.i v20, 0
    vid.v v31
    vcpop.m s3, v0
    li t1, 8
    beq t0, t1, cfg_8
    li t1, 16
    beq t0, t1, cfg_16
    li t1, 22
    beq t0, t1, cfg_22
    j vl_bad
cfg_8:
    li a3, 1920000
    li a4, 1
    j cfg_done
cfg_16:
    li a3, 1920000
    li a4, 1
    j cfg_done
cfg_22:
    li a3, 1920000
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
    li t1, 22
    beq t0, t1, body_22
    j vl_bad
body_8:
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    .rept 12
    add s5, s5, s6
    .endr
    la a5, fp0
    vluxei64.v v0, (a5), v31
    la a5, fp0
    vluxei64.v v0, (a5), v31
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfadd.vv v1, v7, v2
    vfadd.vv v1, v8, v3
    vfadd.vv v1, v9, v4
    vfadd.vv v0, v10, v0
    .rept 99
    add s5, s5, s6
    .endr
    la a5, fp0
    vluxei64.v v0, (a5), v31
    la a5, fp0
    vluxei64.v v0, (a5), v31
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfadd.vv v1, v7, v2
    vfadd.vv v1, v8, v3
    vfadd.vv v1, v9, v4
    vfadd.vv v1, v10, v0
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 820
    add s4, s5, s3
    .endr
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    .rept 12
    add s5, s5, s6
    .endr
    la a5, fp0
    vluxei64.v v0, (a5), v31
    la a5, fp0
    vluxei64.v v0, (a5), v31
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfadd.vv v1, v7, v2
    vfadd.vv v1, v8, v3
    vfadd.vv v1, v9, v4
    vfadd.vv v0, v10, v0
    .rept 99
    add s5, s5, s6
    .endr
    la a5, fp0
    vluxei64.v v0, (a5), v31
    la a5, fp0
    vluxei64.v v0, (a5), v31
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfadd.vv v1, v7, v2
    vfadd.vv v1, v8, v3
    vfadd.vv v1, v9, v4
    vfadd.vv v1, v10, v0
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 820
    add s4, s5, s3
    .endr
    j close
body_16:
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    .rept 12
    add s5, s5, s6
    .endr
    li t2, 12
    vsetvli zero, t2, e64, m1
    la a5, fp0
    vluxei64.v v0, (a5), v31
    la a5, fp0
    vluxei64.v v0, (a5), v31
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfadd.vv v1, v7, v2
    vfadd.vv v1, v8, v3
    vfadd.vv v1, v9, v4
    vfadd.vv v1, v10, v0
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 820
    add s4, s5, s3
    .endr
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    .rept 12
    add s5, s5, s6
    .endr
    la a5, fp0
    vluxei64.v v0, (a5), v31
    la a5, fp0
    vluxei64.v v0, (a5), v31
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfadd.vv v1, v7, v2
    vfadd.vv v1, v8, v3
    vfadd.vv v1, v9, v4
    vfadd.vv v1, v10, v0
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 820
    add s4, s5, s3
    .endr
    j close
body_22:
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    .rept 12
    add s5, s5, s6
    .endr
    li t2, 12
    vsetvli zero, t2, e64, m1
    la a5, fp0
    vluxei64.v v0, (a5), v31
    la a5, fp0
    vluxei64.v v0, (a5), v31
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfadd.vv v1, v7, v2
    vfadd.vv v1, v8, v3
    vfadd.vv v1, v9, v4
    vfadd.vv v1, v10, v0
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 820
    add s4, s5, s3
    .endr
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    vmv1r.v v8, v0
    vmv1r.v v9, v1
    vmv1r.v v10, v2
    vmv1r.v v11, v3
    .rept 12
    add s5, s5, s6
    .endr
    la a5, fp0
    vluxei64.v v0, (a5), v31
    la a5, fp0
    vluxei64.v v0, (a5), v31
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v5, v0, ft0
    vfadd.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v0, v5, v0
    vfadd.vv v1, v6, v1
    vfadd.vv v1, v7, v2
    vfadd.vv v1, v8, v3
    vfadd.vv v1, v9, v4
    vfadd.vv v1, v10, v0
    vfredusum.vs v0, v0, v0
    vcpop.m t6, v20
    .rept 820
    add s4, s5, s3
    .endr
    j close
close:
    sub a3, a3, a4
    bgtz a3, loop
    ret
