"""An imdb-backed image dataset with a bounded in-RAM cache; port of
`boxer_tpu/dataset/helper/image_dataset.py` (the reference's
`e2edet/dataset/helper/image_dataset.py`): records with an `img_path`
field, read from each of several image directories. A side path of the
data layer; the COCO and Waymo tasks do not use it.
"""

import os
from typing import Any, Dict, List, Sequence

from boxer_tpu_torch.dataset.reader.image_reader import ImageReader


class ImageDataset:
    """imdb-record dataset: item i -> {"image": <first directory's image>}.

    directories: base paths searched for each record's `img_path`
    imdb:        sequence of dicts with an `img_path` field
    max_img_cache: bounded whole-image cache (reference default 500)
    """

    def __init__(self, directories: Sequence[str], imdb: Sequence[Dict],
                 reader_type: str = "pil", max_img_cache: int = 500):
        self.directories = list(directories)
        self.reader = ImageReader(backend=reader_type)
        self.imdb = imdb
        self.max_cache = max_img_cache
        self._cache: Dict[str, List[Any]] = {}

    def _read_images(self, image_file: str) -> List[Any]:
        return [self.reader(os.path.join(d, image_file))
                for d in self.directories]

    def _get_images(self, image_file: str) -> List[Any]:
        images = self._cache.get(image_file)
        if images is None:
            images = self._read_images(image_file)
            if len(self._cache) < self.max_cache:
                self._cache[image_file] = images
        return images

    def __len__(self) -> int:
        # reference drops the trailing record (`image_dataset.py:53`)
        return len(self.imdb) - 1

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        info = self.imdb[idx]
        image_file = info.get("img_path")
        if image_file is None:
            raise AttributeError("Missing 'img_path' field in imdb")
        return {"image": self._get_images(image_file)[0]}
