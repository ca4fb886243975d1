from .contrastive import supcon_loss
from .gan import (
    adaptive_disc_weight,
    discriminator_loss,
    generator_loss,
    hinge_d_loss,
    hinge_g_loss,
    vanilla_d_loss,
    vanilla_g_loss,
)

__all__ = ["supcon_loss", "adaptive_disc_weight", "discriminator_loss",
           "generator_loss", "hinge_d_loss", "hinge_g_loss",
           "vanilla_d_loss", "vanilla_g_loss"]
