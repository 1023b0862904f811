"""StyleGAN autoencoders: an encoder and a generator as decoder
(counterpart of synthesis_in_style_tpu/models/autoencoder.py).

Each composition holds `encoder` (or `latent_encoder` and `noise_encoder`)
and `decoder` submodules; its state dict is theirs under those prefixes.
The decoder is frozen in training by leaving it out of the optimizer:
`encoder_parameters()` lists what an autoencoder trains (the JAX package's
`encoder_param_mask`). Training mode is the module's (`.train()` /
`.eval()`); only the encoders' BatchNorms depend on it.

Where a JAX composition draws noise (a decode without predicted noise, the
dropout mix, the super-resolution padding, the two-stem noise when its
noise encoder is off), the port draws from an explicit `torch.Generator`
(`generator=`, on the images' device; None is torch's default generator).
Every draw goes through one method of the composition (`draw_noise`, and
`draw_dropout` for the dropout mix), so a caller can replace it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synthesis_in_style_tpu_torch.models.encoder import Latents
from synthesis_in_style_tpu_torch.ops.resize import resize_linear


def is_wplus(latents: Latents) -> bool:
    return latents.latent is not None and latents.latent.ndim == 3


def _draw(decoder: nn.Module, batch: int, like: torch.Tensor,
          generator: Optional[torch.Generator], start: int = 0) -> List[torch.Tensor]:
    """Fresh N(0, 1) noise (batch, H, W, 1) for the decoder's layers from
    `start` on."""
    return [torch.randn((batch,) + tuple(shape[1:]), generator=generator, device=like.device,
                        dtype=like.dtype)
            for shape in decoder.noise_shapes()[start:]]


class _Composition(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def encode(self, x: torch.Tensor) -> Latents:
        return self.encoder(x)

    def encoder_parameters(self) -> List[nn.Parameter]:
        """The parameters an autoencoder trains: its encoders', never the
        decoder's."""
        return [p for name, p in self.named_parameters() if not name.startswith("decoder.")]

    def draw_noise(self, batch: int, like: torch.Tensor, generator: Optional[torch.Generator],
                   start: int = 0) -> List[torch.Tensor]:
        return _draw(self.decoder, batch, like, generator, start)

    def _decode(self, latent: torch.Tensor, noise: Optional[Sequence[torch.Tensor]],
                input_is_latent: bool, **kwargs):
        """The decoder's forward on one latent with these noise maps (None:
        a StyleGAN2 decoder's stored buffers)."""
        return self.decoder([latent], input_is_latent=input_is_latent,
                            noise=None if noise is None else list(noise),
                            randomize_noise=False, **kwargs)


class StyleganAutoencoder(_Composition):
    """encode -> decode. Without predicted noise (or with
    use_generated_noise=False) the decode draws fresh noise maps, never the
    decoder's stored buffers."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, use_generated_noise: bool = True):
        super().__init__(encoder, decoder)
        self.use_generated_noise = use_generated_noise

    def decode(self, latents: Latents, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        noise = latents.noise
        if noise is None:
            noise = self.draw_noise(latents.latent.shape[0], latents.latent, generator)
        image, _ = self._decode(latents.latent, noise, is_wplus(latents))
        return image

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        latents = self.encode(x)
        if not self.use_generated_noise:
            latents = latents.replace(noise=None)
        return self.decode(latents, generator)


class DropoutStyleganAutoencoder(_Composition):
    """Each predicted noise map is replaced by fresh N(0, 1) noise when a
    uniform draw is at or below `dropout_ratio`."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, dropout_ratio: float = 0.5):
        super().__init__(encoder, decoder)
        self.dropout_ratio = dropout_ratio

    def draw_dropout(self, noise: Sequence[torch.Tensor], generator: Optional[torch.Generator]
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(keep flags as 0-d bool tensors, random maps), one per noise map."""
        keep, random = [], []
        for predicted in noise:
            keep.append(torch.rand((), generator=generator, device=predicted.device)
                        > self.dropout_ratio)
            random.append(torch.randn(predicted.shape, generator=generator,
                                      device=predicted.device, dtype=predicted.dtype))
        return keep, random

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        latents = self.encode(x)
        keep, random = self.draw_dropout(latents.noise, generator)
        mixed = [torch.where(k, p, r) for k, p, r in zip(keep, latents.noise, random)]
        image, _ = self._decode(latents.latent, mixed, is_wplus(latents))
        return image


class CodeStyleganAutoencoder(_Composition):
    """The info code concatenated to w, then mapped by the decoder's MLP."""

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        latents = self.encode(x)
        latent = torch.cat([latents.latent, latents.code], dim=1)
        image, _ = self._decode(latent, latents.noise, False)
        return image


class ContentAndStyleStyleganAutoencoder(_Composition):
    """A 6-channel (content | style) input; `generator` is unused (the JAX
    composition draws nothing)."""

    def forward(self, content_images: torch.Tensor, style_images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        latents = self.encode(torch.cat([content_images, style_images], dim=-1))
        image, _ = self._decode(latents.latent, latents.noise, is_wplus(latents))
        return image


class SuperResolutionStyleganAutoencoder(_Composition):
    """The encoder at its own (lower) resolution, the decoder at its own:
    the input is box-averaged down (no gradient); the missing noise maps are
    fresh noise or the last predicted map upsampled bilinearly, and the
    missing w+ rows repeat the last one (no gradient)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 extend_noise_with_random: bool = True):
        super().__init__(encoder, decoder)
        self.extend_noise_with_random = extend_noise_with_random

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        enc_size = self.encoder.image_size
        with torch.no_grad():
            nchw = x.permute(0, 3, 1, 2)
            if x.shape[1] % enc_size == 0:
                f = x.shape[1] // enc_size
                small = F.avg_pool2d(nchw, f, f)
            else:
                small = resize_linear(nchw, enc_size, enc_size)
            small = small.permute(0, 2, 3, 1)
        latents = self.encode(small)
        noise = list(latents.noise)
        latent = latents.latent
        if self.decoder.size > enc_size:
            num_predicted = len(noise)
            if self.extend_noise_with_random:
                noise += self.draw_noise(x.shape[0], x, generator, start=num_predicted)
            else:
                current = noise[-1]
                for shape in self.decoder.noise_shapes()[num_predicted:]:
                    with torch.no_grad():
                        current = resize_linear(current.permute(0, 3, 1, 2), shape[1],
                                                shape[2]).permute(0, 2, 3, 1)
                    noise.append(current)
            if latent is not None and latent.ndim == 3:
                last = latent[:, -1:].detach()
                pad = last.expand(-1, self.decoder.n_latent - latent.shape[1], -1)
                latent = torch.cat([latent, pad], dim=1)
        image, _ = self._decode(latent, noise, latent.ndim == 3)
        return image


class TwoStemStyleganAutoencoder(_Composition):
    """Separate latent and noise encoders; `update_latent` / `update_noise`
    choose which stem the gradient reaches (a noise stem that is off is
    replaced by fresh noise)."""

    def __init__(self, latent_encoder: nn.Module, noise_encoder: nn.Module,
                 decoder: nn.Module, update_latent: bool = True, update_noise: bool = True):
        nn.Module.__init__(self)
        self.latent_encoder = latent_encoder
        self.noise_encoder = noise_encoder
        self.decoder = decoder
        self.update_latent = update_latent
        self.update_noise = update_noise

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Latents:
        if not (self.update_latent or self.update_noise):
            raise AssertionError("'update_latent' or 'update_noise' must be true for Two "
                                 "Stem Autoencoder")
        latent = self.latent_encoder(x).latent
        if not self.update_latent:
            latent = latent.detach()
        if self.update_noise:
            noise = self.noise_encoder(x).noise
        else:
            noise = tuple(self.draw_noise(x.shape[0], x, generator))
        return Latents(latent=latent, noise=noise)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        latents = self.encode(x, generator)
        image, _ = self._decode(latents.latent, latents.noise, is_wplus(latents))
        return image
