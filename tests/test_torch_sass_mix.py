"""tools/sass_mix.py's reading of `cuobjdump -sass` output (the tool
itself runs on the card's machine, which has the CUDA toolkit): on a
fixed listing of two kernels it finds each one's innermost loop with
global loads, through a label or an address, and counts its
instructions per sample by class; the backward's samples are counted
from its tap loads alone where it stages its cotangent in shared
memory, and from its tap and cotangent loads where it does not."""

from mvskit_tpu_torch.tools import sass_mix

LISTING = """
\t\tFunction : _Z12fused_kernelILi1ELi7ELi0EEvPKi
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x000 */
.L_x_1:
        /*0010*/                   I2F.U32.RP R4, R2 ;                    /* 0x000 */
        /*0020*/                   MUFU.RCP R4, R4 ;                      /* 0x000 */
.L_x_2:
        /*0030*/                   LDG.E.CONSTANT R5, [R2.64] ;           /* 0x000 */
        /*0040*/                   LDG.E.CONSTANT R6, [R2.64+0x4] ;       /* 0x000 */
        /*0050*/                   PRMT R7, R5, 0x7440, R8 ;              /* 0x000 */
        /*0060*/                   FADD R7, R7, -8388608 ;                /* 0x000 */
        /*0070*/                   STS [R9], R7 ;                         /* 0x000 */
        /*0080*/               @P0 BRA `(.L_x_2) ;                        /* 0x000 */
        /*0090*/               @P1 BRA `(.L_x_1) ;                        /* 0x000 */
        /*00a0*/                   EXIT ;                                 /* 0x000 */
\t\tFunction : _Z13window_kernelILi3ELi7ELi0EEvPKi
        /*0000*/                   I2F R4, R2 ;                           /* 0x000 */
        /*0010*/                   LDS.64 R4, [R3] ;                      /* 0x000 */
        /*0020*/                   LDG.E.CONSTANT R5, [R2.64] ;           /* 0x000 */
        /*0030*/                   LDG.E.CONSTANT R6, [R2.64+0x4] ;       /* 0x000 */
        /*0040*/                   LDG.E.CONSTANT R7, [R2.64+0x8] ;       /* 0x000 */
        /*0050*/                   LDG.E.CONSTANT R8, [R2.64+0xc] ;       /* 0x000 */
        /*0060*/                   BRA 0x0 ;                              /* 0x000 */
"""


def test_sampling_loop_counts_per_sample():
    funcs = sass_mix.parse_sass(LISTING)
    assert set(funcs) == {"fused_kernel<1, 7, 0>", "window_kernel<3, 7, 0>"}
    luma = sass_mix.sampling_loop("fused_kernel<1, 7, 0>", funcs["fused_kernel<1, 7, 0>"])
    assert luma["instructions"] == 6 and luma["samples_per_pass"] == 2
    assert luma["counts"]["ldg"] == 2 and luma["counts"]["int_div"] == 0
    assert luma["per_sample"]["prmt"] == 0.5 and luma["per_sample"]["fp32"] == 0.5
    rgb = sass_mix.sampling_loop("window_kernel<3, 7, 0>", funcs["window_kernel<3, 7, 0>"])
    assert rgb["samples_per_pass"] == 1 and rgb["instructions"] == 7
    assert rgb["counts"]["conv"] == 1 and rgb["counts"]["lds"] == 1
    assert sass_mix.classify("I2F", ".U32.RP") == "int_div"


GRAD_LISTING = """
\t\tFunction : _Z18window_grad_kernelILi3ELi7EEvPKi
.L_x_5:
        /*0000*/                   LDG.E.CONSTANT R4, [R2.64] ;           /* 0x000 */
        /*0010*/                   LDG.E.CONSTANT R5, [R2.64+0x4] ;       /* 0x000 */
        /*0020*/                   LDG.E.CONSTANT R6, [R2.64+0x8] ;       /* 0x000 */
        /*0030*/                   LDG.E.CONSTANT R7, [R2.64+0xc] ;       /* 0x000 */
        /*0040*/                   LDG.E.CONSTANT R8, [R10.64] ;          /* 0x000 */
        /*0050*/                   LDG.E.CONSTANT R9, [R10.64+0xc4] ;     /* 0x000 */
        /*0060*/                   LDG.E.CONSTANT R11, [R10.64+0x188] ;   /* 0x000 */
        /*0070*/               @P0 BRA `(.L_x_5) ;                        /* 0x000 */
\t\tFunction : _Z18window_grad_kernelILi1ELi7EEvPKi
.L_x_6:
        /*0000*/                   LDG.E.CONSTANT R4, [R2.64] ;           /* 0x000 */
        /*0010*/                   LDG.E.CONSTANT R5, [R2.64+0x400] ;     /* 0x000 */
        /*0020*/                   LDS R6, [R3] ;                         /* 0x000 */
        /*0030*/                   LDS R7, [R3+0x1c] ;                    /* 0x000 */
        /*0040*/                   SHFL.BFLY PT, R8, R6, 0x4, 0x1f ;      /* 0x000 */
        /*0050*/                   FADD R6, R6, R8 ;                      /* 0x000 */
        /*0060*/               @P0 BRA `(.L_x_6) ;                        /* 0x000 */
"""


def test_sampling_loop_counts_backward_samples_of_both_designs():
    funcs = sass_mix.parse_sass(GRAD_LISTING)
    # one warp a window: 4 tap words and 3 cotangent floats from global memory
    rgb = sass_mix.sampling_loop("window_grad_kernel<3, 7>", funcs["window_grad_kernel<3, 7>"])
    assert rgb["loads_per_sample"] == 7 and rgb["samples_per_pass"] == 1
    assert rgb["per_sample_total"] == 8
    # the cotangent staged in shared memory: the tap word alone
    luma = sass_mix.sampling_loop("window_grad_kernel<1, 7>", funcs["window_grad_kernel<1, 7>"])
    assert luma["loads_per_sample"] == 1 and luma["samples_per_pass"] == 2
    assert luma["per_sample"]["lds"] == 1
    # the walk alone: first global load to first shuffle, 4 of 7 instructions
    assert luma["walk_per_sample_total"] == 2 and luma["per_sample_total"] == 3.5
    assert "walk_per_sample_total" not in rgb
    assert sass_mix.loads_per_sample("window_grad_kernel<1, 0>", []) == 2
    assert sass_mix.loads_per_sample("window_kernel<3, 0, 0>", []) == 4
