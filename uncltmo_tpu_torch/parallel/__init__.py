"""Multi-card execution: `torch.distributed` for training, device lists
for serving."""
