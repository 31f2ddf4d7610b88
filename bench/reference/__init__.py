"""The plain reference: the architecture's equations in plain PyTorch, in
float32 with TF32 off (``fp32``), or with every product's operands rounded
to float8 e4m3 (``fp8``, the control).  It imports nothing of the program;
it reads the benchmark's weights and inputs and the program's outputs only
to judge them."""
