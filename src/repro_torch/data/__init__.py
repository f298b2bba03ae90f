from repro_torch.data.pipeline import DataConfig, batches_for_model, frontend_stub, token_batches
