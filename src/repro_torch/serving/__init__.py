from repro_torch.serving.serve import ZooServer

__all__ = ["ZooServer"]
