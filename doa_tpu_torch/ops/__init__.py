"""Core DoA ops of the port (torch tensors; kernels under ops.cuda)."""
