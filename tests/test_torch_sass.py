"""utils/sass.py's readers of cuobjdump -sass listings, on a listing
written out here in cuobjdump's format (the toolkit runs only on the
card's machine): the split into kernels, opcode counts, and the loops
`loop_bodies` finds from branches back to an earlier address."""

import pytest

from kangaroo_torch.utils import sass

LISTING = """
\tcode for sm_90a
\t\tFunction : _Z5chainPi
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x1, PT ;
        /*0020*/              @!P0 BRA 0x90 ;
        /*0030*/                   IADD3 R2, P1, -R3, R2, RZ ;
        /*0040*/                   IADD3.X R4, P1, ~R5, R4, RZ, P1, !PT ;
        /*0050*/                   IMAD.X R6, R6, 0x1, ~R7, P1 ;
        /*0060*/                   UIADD3 UR5, UR5, -0x1, URZ ;
        /*0070*/                   ISETP.NE.AND P0, PT, RZ, UR5, PT ;
        /*0080*/               @P0 BRA 0x30 ;
        /*0090*/                   STG.E desc[UR8][R8.64], R2 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
        /*00c0*/                   NOP;
\t\t..........

\t\tFunction : _Z6nestedPi
        /*0000*/                   MOV R0, RZ ;
        /*0010*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0020*/                   LOP3.LUT R2, R1, 0xff, RZ, 0xc0, !PT ;
        /*0030*/               @P1 BRA 0x10 ;
        /*0040*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0050*/               @P0 BRA 0x0 ;
        /*0060*/                   EXIT ;

\t\tFunction : _Z4flatPi
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0010*/               @P0 BRA 0x30 ;
        /*0020*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0030*/                   EXIT ;
        /*0040*/                   BRA 0x40;
"""


def test_split_functions_and_counts():
    funcs = sass.split_functions(LISTING)
    assert sorted(funcs) == ["_Z4flatPi", "_Z5chainPi", "_Z6nestedPi"]
    assert [len(funcs[k]) for k in ("_Z5chainPi", "_Z6nestedPi",
                                    "_Z4flatPi")] == [13, 7, 5]
    counts = sass.opcode_counts(funcs["_Z5chainPi"])
    assert counts["IADD3"] == 1 and counts["IADD3.X"] == 1
    assert counts["BRA"] == 3 and sum(counts.values()) == 13
    # IMAD.X (a carry add on the multiply-add pipe) counts as IMAD
    assert sass.count_class(counts, "IMAD") == 1
    assert sass.count_class(counts, "IADD3") == 2


@pytest.mark.parametrize("name,want", [
    # one loop; the forward branch and the trap's branch to itself are
    # none
    ("_Z5chainPi", [["IADD3", "IADD3.X", "IMAD.X", "UIADD3",
                     "ISETP.NE.AND", "BRA"]]),
    # the inner loop, then the outer one around it
    ("_Z6nestedPi", [["IADD3", "LOP3.LUT", "BRA"],
                     ["MOV", "IADD3", "LOP3.LUT", "BRA", "IADD3", "BRA"]]),
    ("_Z4flatPi", []),
])
def test_loop_bodies(name, want):
    lines = sass.split_functions(LISTING)[name]
    got = [[sass._INSN.search(x).group(1) for x in body]
           for body in sass.loop_bodies(lines)]
    assert got == want


CHAIN = ["        /*0000*/                   IADD3 R2, P1, R3, R2, RZ ;",
         "        /*0010*/                   IMAD.WIDE.U32 R8, R4, R5, RZ ;"]


@pytest.mark.parametrize("tail,lost", [
    # the carry read by the chain's next add, then its predicate reused
    (["        /*0020*/                   IADD3.X R4, R5, R4, RZ, P1, !PT ;",
      "        /*0030*/                   ISETP.GE.AND P1, PT, R0, 0x1, PT ;"],
     []),
    # read as a guard, then overwritten by an address computation
    (["        /*0020*/               @P1 BRA 0x40 ;",
      "        /*0030*/                   LEA R18, P1, R6, R7, 0x4 ;"], []),
    # read by a select (a chain's last carry as 0 or 1)
    (["        /*0020*/                   SEL R19, RZ, 0x1, !P1 ;",
      "        /*0030*/                   IADD3 R9, P1, R1, R9, RZ ;"], []),
    # overwritten by a compare before the chain reads it
    (["        /*0020*/                   ISETP.GE.AND P1, PT, R0, 0x1, PT ;",
      "        /*0030*/                   IADD3.X R4, R5, R4, RZ, P1, !PT ;"],
     [0]),
    # overwritten by another add's carry
    (["        /*0020*/                   IADD3 R6, P1, R7, R6, RZ ;",
      "        /*0030*/                   IADD3.X R4, R5, R4, RZ, P1, !PT ;"],
     [0]),
], ids=["read", "guard", "select", "compare", "add"])
def test_lost_carries(tail, lost):
    """lost_carries flags the instruction that overwrites an IADD3's
    carry before any instruction reads it, and nothing else."""
    assert sass.lost_carries(CHAIN + tail) == [tail[i] for i in lost]
