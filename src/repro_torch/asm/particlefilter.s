# particlefilter: RVV v1.0 kernel emitted by repro.core.codegen -- do not edit.
# Decodes (repro.core.rvv) to the jaxpr-lowered trace, bitwise, at
# every effective MVL in {8/16/32/64/128/256}; the .chunk loop's bgtz
# counter encodes the exact fractional trip count.
    .text
    .globl particlefilter
    .stream fp0 781.0
particlefilter:
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
    li a3, 3455848845218065
    li a4, 2147483648
    j cfg_done
cfg_16:
    li a3, 3455848845218065
    li a4, 4294967296
    j cfg_done
cfg_32:
    li a3, 3455848845218065
    li a4, 8589934592
    j cfg_done
cfg_64:
    li a3, 3455848845218065
    li a4, 17179869184
    j cfg_done
cfg_128:
    li a3, 3455848845218065
    li a4, 34359738368
    j cfg_done
cfg_256:
    li a3, 3455848845218065
    li a4, 68719476736
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
    vfexp.v v0, ft0
    vfmul.vf v1, ft0, ft1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfdiv.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfdiv.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v2, v3, v9
    vfexp.v v3, v4
    vfadd.vv v4, v5, v0
    vfadd.vv v1, v6, v1
    vfexp.v v1, v7
    vfadd.vv v1, v8, v2
    vfdiv.vv v1, v9, v3
    vfmul.vv v1, v10, v4
    vfexp.v v0, v0
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    j close
body_16:
    la a5, fp0
    vle64.v v0, (a5)
    vfexp.v v0, ft0
    vfmul.vf v1, ft0, ft1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfdiv.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfdiv.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v2, v3, v9
    vfexp.v v3, v4
    vfadd.vv v4, v5, v0
    vfadd.vv v1, v6, v1
    vfexp.v v1, v7
    vfadd.vv v1, v8, v2
    vfdiv.vv v1, v9, v3
    vfmul.vv v1, v10, v4
    vfexp.v v0, v0
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    j close
body_32:
    la a5, fp0
    vle64.v v0, (a5)
    vfexp.v v0, ft0
    vfmul.vf v1, ft0, ft1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfdiv.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfdiv.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v2, v3, v9
    vfexp.v v3, v4
    vfadd.vv v4, v5, v0
    vfadd.vv v1, v6, v1
    vfexp.v v1, v7
    vfadd.vv v1, v8, v2
    vfdiv.vv v1, v9, v3
    vfmul.vv v1, v10, v4
    vfexp.v v0, v0
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    j close
body_64:
    la a5, fp0
    vle64.v v0, (a5)
    vfexp.v v0, ft0
    vfmul.vf v1, ft0, ft1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfdiv.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfdiv.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v2, v3, v9
    vfexp.v v3, v4
    vfadd.vv v4, v5, v0
    vfadd.vv v1, v6, v1
    vfexp.v v1, v7
    vfadd.vv v1, v8, v2
    vfdiv.vv v1, v9, v3
    vfmul.vv v1, v10, v4
    vfexp.v v0, v0
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    j close
body_128:
    la a5, fp0
    vle64.v v0, (a5)
    vfexp.v v0, ft0
    vfmul.vf v1, ft0, ft1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfdiv.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfdiv.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v2, v3, v9
    vfexp.v v3, v4
    vfadd.vv v4, v5, v0
    vfadd.vv v1, v6, v1
    vfexp.v v1, v7
    vfadd.vv v1, v8, v2
    vfdiv.vv v1, v9, v3
    vfmul.vv v1, v10, v4
    vfexp.v v0, v0
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    j close
body_256:
    la a5, fp0
    vle64.v v0, (a5)
    vfexp.v v0, ft0
    vfmul.vf v1, ft0, ft1
    vfmul.vf v2, ft0, ft1
    vid.v v3
    vid.v v4
    vfmul.vf v5, v0, ft0
    vfmul.vf v6, v1, ft0
    vfadd.vf v7, v2, ft0
    vfadd.vf v8, v3, ft0
    vfadd.vf v9, v4, ft0
    vfadd.vf v10, v5, ft0
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfexp.v v3, v3
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfdiv.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfexp.v v0, v0
    vfadd.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfdiv.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfexp.v v6, v6
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfexp.v v0, v0
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfexp.v v1, v1
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfdiv.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfexp.v v10, v10
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfdiv.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfexp.v v3, v3
    vfdiv.vv v4, v4, v10
    vfdiv.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfdiv.vv v1, v1, v7
    vfdiv.vv v2, v2, v8
    vfexp.v v3, v3
    vfexp.v v4, v4
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfmul.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfmul.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfexp.v v6, v6
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfdiv.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfadd.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfdiv.vv v7, v7, v2
    vfmul.vv v8, v8, v3
    vfdiv.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfadd.vv v7, v7, v2
    vfexp.v v8, v8
    vfmul.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfdiv.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfadd.vv v3, v3, v9
    vfmul.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfadd.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfexp.v v5, v5
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfdiv.vv v8, v8, v3
    vfexp.v v9, v9
    vfadd.vv v10, v10, v5
    vfadd.vv v0, v0, v6
    vfmul.vv v1, v1, v7
    vfadd.vv v2, v2, v8
    vfexp.v v3, v3
    vfadd.vv v4, v4, v10
    vfadd.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfmul.vv v7, v7, v2
    vfexp.v v8, v8
    vfadd.vv v9, v9, v4
    vfadd.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfexp.v v1, v1
    vfexp.v v2, v2
    vfadd.vv v3, v3, v9
    vfadd.vv v4, v4, v10
    vfmul.vv v5, v5, v0
    vfmul.vv v6, v6, v1
    vfexp.v v7, v7
    vfadd.vv v8, v8, v3
    vfmul.vv v9, v9, v4
    vfmul.vv v10, v10, v5
    vfmul.vv v0, v0, v6
    vfadd.vv v1, v1, v7
    vfmul.vv v2, v2, v8
    vfadd.vv v2, v3, v9
    vfexp.v v3, v4
    vfadd.vv v4, v5, v0
    vfadd.vv v1, v6, v1
    vfexp.v v1, v7
    vfadd.vv v1, v8, v2
    vfdiv.vv v1, v9, v3
    vfmul.vv v1, v10, v4
    vfexp.v v0, v0
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    vid.v v0
    vid.v v1
    vid.v v2
    vid.v v3
    vid.v v4
    vfadd.vf v0, v0, ft0
    vfadd.vf v1, v1, ft0
    vfadd.vf v1, v2, ft0
    vfadd.vf v1, v3, ft0
    vfadd.vf v1, v4, ft0
    vfadd.vf v0, v0, ft0
    vcpop.m t6, v5
    vcpop.m t6, v6
    .rept 84
    add s4, s5, s3
    .endr
    j close
close:
    sub a3, a3, a4
    bgtz a3, loop
    ret
