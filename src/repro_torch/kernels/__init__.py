# Hopper kernels (csrc/ + Triton), their plain versions, and ops dispatch.
