from repro_torch.serving.engine import BatchResult, Request, ServeEngine

__all__ = ["ServeEngine", "Request", "BatchResult"]
