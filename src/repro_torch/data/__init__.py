from .pipeline import (SyntheticPipeline, TokenFilePipeline, stub_frames,
                       stub_image_embeds)

__all__ = ["SyntheticPipeline", "TokenFilePipeline", "stub_frames",
           "stub_image_embeds"]
