from .dataset import Dataset, RawFrame, open_dataset, imread
