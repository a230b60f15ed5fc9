"""The plain reference of ALiVE-VC's conversion paths: plain PyTorch in
float32 with TF32 off, written for the benchmark alone.  It imports nothing
of the program under test and takes nothing the program made: the seeded
weights (by the reference's own parameter names) and the inputs are all it
reads."""
