"""NN building blocks with the reference's parameter names and layouts."""
