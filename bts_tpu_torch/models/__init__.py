from bts_tpu_torch.models.bts import BtsDecoder, BtsModel, create_model  # noqa: F401
