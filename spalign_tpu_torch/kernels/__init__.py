"""The port's hand-written CUDA kernels beside their plain PyTorch
versions: SLIC on the device (the Lloyd loop and the assignment step),
SegNet's 2x2 pooling and the folded DRN's epilogue."""


def launch_counts() -> dict:
    """This process's kernel launches so far, by kernel (each wrapper
    counts the launches of its kernel, for proof of the path taken)."""
    from spalign_tpu_torch.kernels import (drn_epilogue, pooling,
                                           slic_assign, slic_fused)

    return {"slic_lloyd": slic_fused.slic_lloyd.launches,
            "slic_assign": slic_assign.slic_assign.launches,
            "slic_assign_sums": slic_assign.slic_assign.sums_launches,
            "pool2x2": pooling.pool2x2.launches,
            "scatter2x2": pooling.scatter2x2.launches,
            "gather2x2": pooling.gather2x2.launches,
            "drn_epilogue": drn_epilogue.drn_epilogue.launches}
