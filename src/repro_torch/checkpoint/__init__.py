from repro_torch.checkpoint.checkpointer import latest_step, restore_checkpoint, save_checkpoint
