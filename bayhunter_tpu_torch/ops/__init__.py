"""Forward solvers, likelihood laws and the hand-written CUDA kernels
(``prep``: K1 model operands, ``walk``: K2 warm root walker, ``resp``:
K3 RF reflectivity response) with their plain PyTorch twins."""
