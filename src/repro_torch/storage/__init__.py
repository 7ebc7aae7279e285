from repro_torch.storage.object_store import ObjectStore, StudyStore

__all__ = ["ObjectStore", "StudyStore"]
