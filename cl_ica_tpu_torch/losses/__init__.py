from .infonce import CLLoss, LpSimCLRLoss, logmeanexp, pairwise_lp_distance

__all__ = ["CLLoss", "LpSimCLRLoss", "logmeanexp", "pairwise_lp_distance"]
