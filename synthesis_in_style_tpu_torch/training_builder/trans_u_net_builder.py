"""TransUNet train builder (counterpart of
synthesis_in_style_tpu/training_builder/trans_u_net_builder.py): the network
from the config's `pretrained_model_name`, `num_skip_channels`,
`vit_patch_size` and `attention_impl` ("xla" by default, "flash" for the
fused attention kernel), the original ViT `.npz` of `pretrained_path` when
not fine-tuning, SGD with momentum and weight decay at the base builder's
learning-rate schedule, and the 0.5 * CE + 0.5 * Dice step."""

from __future__ import annotations

import copy

import numpy as np

from synthesis_in_style_tpu_torch.models.trans_u_net import (
    VIT_CONFIGS,
    VisionTransformer,
    load_npz_weights,
)
from synthesis_in_style_tpu_torch.training_builder.base import BaseTrainBuilder
from synthesis_in_style_tpu_torch.updaters.segmentation_updater import SGDOptimizer


class TransUNetTrainBuilder(BaseTrainBuilder):
    def _build_network(self):
        config = self.config
        transformer_config = copy.deepcopy(
            VIT_CONFIGS[config.get("pretrained_model_name", "R50-ViT-B_16")]())
        transformer_config["n_classes"] = config["num_classes"]
        transformer_config["n_skip"] = config.get("num_skip_channels", 3)
        transformer_config["attention_impl"] = config.get("attention_impl", "xla")
        vit_patch = config.get("vit_patch_size", 16)
        if transformer_config["patches"].get("grid") is not None:
            transformer_config["patches"]["grid"] = (config["image_size"] // vit_patch,
                                                     config["image_size"] // vit_patch)
        return VisionTransformer(transformer_config, img_size=config["image_size"],
                                 num_classes=config["num_classes"])

    def _load_pretrained(self) -> None:
        if self.config.get("fine_tune") or not self.config.get("pretrained_path"):
            return
        with np.load(self.config["pretrained_path"]) as weights:
            state = load_npz_weights(self.network.state_dict(), dict(weights),
                                     self.network.config)
        self.network.load_state_dict(state)

    def _build_optimizer(self) -> SGDOptimizer:
        config = self.config
        return SGDOptimizer(self.network.parameters(), self.lr_schedule(),
                            momentum=float(config.get("momentum", 0.9)),
                            weight_decay=float(config.get("weight_decay", 0.0)))

    def _updater_kwargs(self) -> dict:
        return {"num_classes": int(self.config["num_classes"])}
