from .contrastive import supcon_loss

__all__ = ["supcon_loss"]
